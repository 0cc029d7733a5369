"""
Tests of the kernel ingestion layer (DAF/SPK/LSK/PCK parsing) and the time
system against golden values computed with CSPICE (via the reference
project's committed test expectations).
"""

import glob
import math
import os

import numpy as np
import pytest

from common import KERNEL_PATH

import planetmapper_tpu  # noqa: F401  (enables x64)
from planetmapper_tpu.core.ephemeris import Ephemeris
from planetmapper_tpu.core.time import (
    LeapSecondData,
    et_to_utc_string,
    utc_string_to_et,
)
from planetmapper_tpu.kernels import naif_ids
from planetmapper_tpu.kernels.daf import read_daf
from planetmapper_tpu.kernels.pool import KernelPool, sort_kernel_paths


@pytest.fixture(scope='module')
def pool():
    p = KernelPool()
    paths = []
    for pattern in ('**/*.bsp', '**/*.tls', '**/*.tpc'):
        paths.extend(glob.glob(os.path.join(KERNEL_PATH, pattern), recursive=True))
    for path in sort_kernel_paths(paths):
        p.furnsh(path)
    return p


@pytest.fixture(scope='module')
def lsk(pool):
    return LeapSecondData.from_pool(pool.text)


@pytest.fixture(scope='module')
def eph(pool):
    return Ephemeris(pool)


class TestDaf:
    def test_read_all_fixture_kernels(self):
        paths = glob.glob(os.path.join(KERNEL_PATH, '**/*.bsp'), recursive=True)
        assert len(paths) >= 1
        for path in paths:
            daf = read_daf(path)
            assert daf.nd == 2 and daf.ni == 6
            assert len(daf.summaries) >= 1

    def test_native_matches_python_parser(self):
        # The C++ fast path (native/daf_reader.cpp) serves by default,
        # so every other kernel test exercises it - this is the only
        # place the pure-Python parser (the no-compiler fallback) runs
        # when the shared library exists, and the only direct proof the
        # two parsers agree byte-for-byte.
        from planetmapper_tpu.kernels import daf_native
        from planetmapper_tpu.kernels.daf import read_daf_python

        paths = sorted(
            glob.glob(os.path.join(KERNEL_PATH, '**/*.bsp'), recursive=True)
        )
        native_checked = 0
        for path in paths:
            py = read_daf_python(path)
            nat = daf_native.read_daf_native(path)
            if nat is None:  # no compiler in this environment
                continue
            native_checked += 1
            assert nat.idword == py.idword, path
            assert (nat.nd, nat.ni) == (py.nd, py.ni), path
            assert len(nat.summaries) == len(py.summaries), path
            for a, b in zip(nat.summaries, py.summaries):
                assert a.integers == b.integers, path
                np.testing.assert_array_equal(
                    np.asarray(a.doubles), np.asarray(b.doubles),
                    err_msg=path,
                )
            # raw word array identity over sampled ranges (incl. the
            # file tail, where record-boundary bugs would show)
            n = py._data.size
            for s, e in ((1, min(1024, n)), (max(1, n - 1023), n)):
                np.testing.assert_array_equal(
                    nat.words(s, e), py.words(s, e), err_msg=path
                )
        if daf_native.native_enabled() and daf_native._get_lib():
            assert native_checked == len(paths)


class TestTime:
    # Golden: reference tests/test_body.py:110
    def test_str2et_golden(self, lsk):
        assert utc_string_to_et('2005-01-01T00:00:00', lsk) == pytest.approx(
            157809664.1839331, abs=1e-6
        )

    def test_round_trip(self, lsk):
        for utc in ['2005-01-01T00:00:00.000000', '1999-12-31T23:59:59.123456',
                    '2016-02-29T12:34:56.500000']:
            et = utc_string_to_et(utc, lsk)
            assert et_to_utc_string(et, lsk) == utc

    def test_formats(self, lsk):
        et_ref = utc_string_to_et('2005-01-01T00:00:00', lsk)
        assert utc_string_to_et('2005-01-01', lsk) == et_ref
        assert utc_string_to_et('2005 JAN 01 00:00:00', lsk) == et_ref
        assert utc_string_to_et('2005-001', lsk) == et_ref
        assert utc_string_to_et('JD 2453371.5', lsk) == pytest.approx(et_ref, abs=1e-5)

    def test_leap_second_offsets(self, lsk):
        # delta (ET - UTC) straddling the 2006 leap second
        et_2005 = utc_string_to_et('2005-06-01T00:00:00', lsk)
        et_2006 = utc_string_to_et('2006-06-01T00:00:00', lsk)
        raw_gap = 365 * 86400.0
        assert et_2006 - et_2005 == pytest.approx(raw_gap + 1.0, abs=1e-3)


class TestNaifIds:
    def test_round_trips(self):
        assert naif_ids.bods2c('jupiter') == 599
        assert naif_ids.bods2c(' JuPiTeR ') == 599
        assert naif_ids.bods2c('599') == 599
        assert naif_ids.bods2c(599) == 599
        assert naif_ids.bodc2s(599) == 'JUPITER'
        assert naif_ids.bods2c('HST') == -48
        assert naif_ids.bods2c('daphnis') == 635
        with pytest.raises(naif_ids.BodyNotFoundError):
            naif_ids.bods2c('<<< test >>>')

    def test_canonical_names_space_separated(self):
        # CSPICE bodc2s returns space-separated canonical names, not the
        # underscore aliases or short abbreviations
        assert naif_ids.bodc2s(0) == 'SOLAR SYSTEM BARYCENTER'
        assert naif_ids.bodc2s(3) == 'EARTH BARYCENTER'
        assert naif_ids.bodc2s(5) == 'JUPITER BARYCENTER'
        # but short first-listed aliases stay canonical where CSPICE's
        # are ('HST' - the reference's own reprs depend on this)
        assert naif_ids.bodc2s(-48) == 'HST'


class TestLagrangeSegments:
    """SPK types 9/13 evaluated on synthetic exactly-representable data."""

    @staticmethod
    def _cubic_states(epochs):
        # position components are cubics of t; velocities their exact
        # derivatives (so degree-3 interpolation is exact)
        t = np.asarray(epochs, dtype=float)
        pos = np.stack(
            [t**3 - t, 2.0 * t**2 + 3.0, 0.5 * t**3 + t**2], axis=-1
        )
        vel = np.stack(
            [3.0 * t**2 - 1.0, 4.0 * t, 1.5 * t**2 + 2.0 * t], axis=-1
        )
        return np.concatenate([pos, vel], axis=-1)

    def test_type_9_interpolates_velocity_knots(self):
        from planetmapper_tpu.kernels.spk import LagrangeData, lagrange_state

        epochs = np.linspace(0.0, 10.0, 11)
        data = LagrangeData(
            group=4, hermite=False, epochs=epochs,
            states=self._cubic_states(epochs),
        )
        t = np.array([0.3, 4.75, 9.9])
        out = np.asarray(lagrange_state(data, t))
        assert out.shape == (3, 6)
        np.testing.assert_allclose(out, self._cubic_states(t), atol=1e-9)

    def test_type_13_hermite_window(self):
        from planetmapper_tpu.kernels.spk import LagrangeData, lagrange_state

        epochs = np.linspace(0.0, 10.0, 11)
        data = LagrangeData(
            group=2, hermite=True, epochs=epochs,
            states=self._cubic_states(epochs),
        )
        # 2-point Hermite with exact derivatives reproduces cubics exactly
        t = np.array([1.5, 7.25])
        out = np.asarray(lagrange_state(data, t))
        assert out.shape == (2, 3)
        np.testing.assert_allclose(
            out, self._cubic_states(t)[:, :3], atol=1e-9
        )

    def test_trailer_semantics(self):
        # type 9 trailer = polynomial DEGREE (window = degree+1);
        # type 13 trailer = Hermite WINDOW SIZE itself
        from planetmapper_tpu.kernels.spk import _parse_type_9_13

        n = 6
        epochs = np.linspace(0.0, 5.0, n)
        states = self._cubic_states(epochs)
        words9 = np.concatenate(
            [states.ravel(), epochs, [3.0, float(n)]]
        )
        d9 = _parse_type_9_13(words9, 9)
        assert d9.group == 4 and not d9.hermite
        words13 = np.concatenate(
            [states.ravel(), epochs, [4.0, float(n)]]
        )
        d13 = _parse_type_9_13(words13, 13)
        assert d13.group == 4 and d13.hermite


class TestTextKernelGrammar:
    def test_value_on_next_line(self):
        from planetmapper_tpu.kernels.textkernel import parse_text_kernel

        pool = parse_text_kernel(
            '\\begindata\n'
            'SCALAR =\n'
            '   3.0\n'
            'VEC =\n'
            '   ( 1.0 2.0\n'
            '     3.0 )\n'
            'AFTER = 7.0\n'
        )
        assert pool['SCALAR'] == [3.0]
        assert pool['VEC'] == [1.0, 2.0, 3.0]
        assert pool['AFTER'] == [7.0]

    def test_quote_escapes(self):
        from planetmapper_tpu.kernels.textkernel import parse_text_kernel

        pool = parse_text_kernel(
            "\\begindata\nNAME = ( 'IT''S' 'PLAIN' )\n"
        )
        assert pool['NAME'] == ["IT'S", 'PLAIN']

    def test_binary_non_spk_rejected(self, tmp_path):
        from planetmapper_tpu.kernels import pool as pool_mod
        from planetmapper_tpu.kernels.spk import SpkError

        path = tmp_path / 'earth.bpc'
        path.write_bytes(b'DAF/PCK ' + b'\x00' * 100)
        kp = pool_mod.KernelPool()
        with pytest.raises(SpkError, match='DAF/PCK'):
            kp.furnsh(str(path))
        assert str(path) not in kp.loaded_files


class TestPck:
    def test_jupiter_radii(self, pool):
        radii = pool.bodvar(599, 'RADII', 3)
        assert list(radii) == [71492.0, 71492.0, 66854.0]

    def test_pm_spin_sense(self, pool):
        assert pool.bodvar(599, 'PM')[1] > 0  # Jupiter prograde
        assert pool.bodvar(799, 'PM')[1] < 0  # Uranus retrograde


class TestEphemeris:
    """Golden values from reference tests (CSPICE-derived)."""

    ET = 157809664.1839331  # 2005-01-01T00:00:00 UTC

    @pytest.mark.reference_data
    def test_jupiter_from_hst_cn(self, eph):
        # Goldens: reference tests/test_basic_body.py:28-33. HST positions
        # come from an independent SGP4 implementation so agree with CSPICE
        # to ~15 m; angular tolerances here are ~100x tighter than the
        # sub-millidegree parity requirement.
        state, lt = eph.spkezr(599, -48, self.ET, 'CN')
        state = np.asarray(state)
        assert float(lt) == pytest.approx(2734.018326542542, abs=1e-6)
        pos = state[:3]
        ra = math.degrees(math.atan2(pos[1], pos[0])) % 360
        dec = math.degrees(math.asin(pos[2] / np.linalg.norm(pos)))
        assert ra == pytest.approx(196.37198562427025, abs=1e-7)
        assert dec == pytest.approx(-5.565793847134351, abs=1e-7)

    def test_jupiter_from_earth_geometric_vs_lt(self, eph):
        state_none, lt_none = eph.spkezr(599, 399, self.ET, 'NONE')
        state_cn, lt_cn = eph.spkezr(599, 399, self.ET, 'CN')
        # Light time correction moves apparent position by ~ lt * omega
        assert float(lt_none) == pytest.approx(float(lt_cn), rel=1e-4)
        assert not np.allclose(state_none[:3], state_cn[:3], atol=100.0)

    def test_cn_plus_s_differs(self, eph):
        state_cn, _ = eph.spkezr(599, 399, self.ET, 'CN')
        state_cns, _ = eph.spkezr(599, 399, self.ET, 'CN+S')
        # Stellar aberration: up to v/c ~ 1e-4 rad at 8.2e8 km distance
        shift = np.linalg.norm(np.asarray(state_cns[:3] - state_cn[:3]))
        assert 1e3 < shift < 2e5

    def test_batched_times_match_scalar(self, eph):
        ets = self.ET + np.linspace(0, 3600.0, 5)
        states, lts = eph.spkezr(599, 399, ets, 'CN')
        for i, et in enumerate(ets):
            s, lt = eph.spkezr(599, 399, float(et), 'CN')
            np.testing.assert_allclose(np.asarray(states)[i], np.asarray(s),
                                       rtol=0, atol=1e-6)

    @pytest.mark.reference_data
    def test_moon_type17_equinoctial(self, eph):
        # AMALTHEA (505) is a type 17 segment in a B1950 frame: check the
        # orbit radius is physically correct (~181,400 km from Jupiter).
        state = np.asarray(eph.rel_state_geometric(505, 599, self.ET))
        r = np.linalg.norm(state[:3])
        assert 175000 < r < 186000
        # speed of a circular orbit at that radius ~ 26.5 km/s
        v = np.linalg.norm(state[3:])
        assert 20.0 < v < 35.0


class TestSgp4:
    """
    SGP4/SDP4 propagation against the published Spacetrack Report #3 test
    cases (the same algorithm pair CSPICE applies to SPK type 10 via
    EV2LIN/DPSPCE; reference consumption path: planetmapper/base.py:828).
    States below are TEME km / km/s from the report's verification tables;
    the original values were produced with single-precision arithmetic, so
    comparisons carry a few-metre tolerance.
    """

    # WGS-72 ("old") geophysical constants, as in STR#3 and the committed
    # HST kernel
    CONSTANTS = np.array([
        1.082616e-3, -2.53881e-6, -1.65597e-6,
        0.0743669161, 120.0, 78.0, 6378.135, 1.0,
    ])

    @staticmethod
    def _tle_epoch_to_et(yy_doy: float) -> float:
        """TLE YYDDD.ddd epoch -> seconds past J2000 (epoch convention of
        the type 10 packets; UTC-as-TDB, consistent with the evaluator)."""
        import datetime

        yy = int(yy_doy // 1000)
        doy = yy_doy - yy * 1000
        year = 1900 + yy if yy >= 57 else 2000 + yy
        offset = datetime.datetime(year, 1, 1) - datetime.datetime(
            2000, 1, 1, 12
        )
        return offset.total_seconds() + (doy - 1.0) * 86400.0

    @classmethod
    def _packet(cls, epoch_yydoy, bstar, incl_deg, node_deg, ecc,
                argp_deg, m_deg, n_revday):
        deg = math.pi / 180.0
        return np.array([[
            0.0, 0.0, bstar, incl_deg * deg, node_deg * deg, ecc,
            argp_deg * deg, m_deg * deg,
            n_revday * 2.0 * math.pi / 1440.0,
            cls._tle_epoch_to_et(epoch_yydoy), 0.0, 0.0, 0.0, 0.0,
        ]])

    def _propagate(self, packet, t_minutes):
        from planetmapper_tpu.kernels import sgp4

        params = sgp4.sgp4_init_packets(self.CONSTANTS, packet)
        c = sgp4.Sgp4Constants(*self.CONSTANTS)
        et = packet[0, 9] + t_minutes * 60.0
        return np.asarray(
            sgp4.sgp4_propagate(c, dict(params), np.array([et]))
        )[0]

    def test_str3_near_earth_88888(self):
        # STR#3 SGP4 test: object 88888, epoch 80275.98708465
        pk = self._packet(
            80275.98708465, 0.66816e-4, 72.8435, 115.9689, 0.0086731,
            52.6988, 110.5714, 16.05824518,
        )
        s0 = self._propagate(pk, 0.0)
        np.testing.assert_allclose(
            s0[:3], [2328.97048951, -5995.22076416, 1719.97067261],
            rtol=0, atol=5e-3,
        )
        np.testing.assert_allclose(
            s0[3:], [2.91207230, -0.98341546, -7.09081703],
            rtol=0, atol=5e-6,
        )
        s360 = self._propagate(pk, 360.0)
        np.testing.assert_allclose(
            s360[:3], [2456.10705566, -6071.93853760, 1222.89727783],
            rtol=0, atol=5e-3,
        )

    def test_str3_deep_space_11801(self):
        # STR#3 SDP4 test: object 11801 (e=0.73 HEO, period ~630 min):
        # exercises the lunar-solar secular + periodic deep-space terms
        from planetmapper_tpu.kernels import sgp4

        pk = self._packet(
            80230.29629788, 0.14311e-1, 46.7916, 230.4354, 0.7318036,
            47.4722, 10.4117, 2.28537848,
        )
        params = sgp4.sgp4_init_packets(self.CONSTANTS, pk)
        assert params['_has_deep']
        assert params['deep'][0] == 1.0
        s0 = self._propagate(pk, 0.0)
        np.testing.assert_allclose(
            s0[:3], [7473.37066650, 428.95261765, 5828.74786377],
            rtol=0, atol=1e-2,
        )
        np.testing.assert_allclose(
            s0[3:], [5.10715413, 6.44468284, -0.18613096],
            rtol=0, atol=1e-5,
        )
        s360 = self._propagate(pk, 360.0)
        np.testing.assert_allclose(
            s360[:3], [-3305.22537232, 32410.86328125, -24697.17675781],
            rtol=0, atol=5e-2,
        )

    def test_geosynchronous_resonance(self):
        # 1:1 resonance class (irez=1): a geostationary element set must
        # classify as synchronous and hold its radius over +-10 days
        from planetmapper_tpu.kernels import sgp4

        pk = self._packet(
            95100.5, 0.0, 0.0300, 80.0, 0.0002, 30.0, 200.0, 1.00273790,
        )
        params = sgp4.sgp4_init_packets(self.CONSTANTS, pk)
        assert params['irez'][0] == 1.0
        for t_days in (-10.0, -1.0, 0.0, 0.5, 3.0, 10.0):
            s = self._propagate(pk, t_days * 1440.0)
            r = np.linalg.norm(s[:3])
            assert 42100.0 < r < 42230.0, (t_days, r)

    def test_molniya_resonance(self):
        # 2:1 resonance class (irez=2): semi-major axis from vis-viva must
        # stay at the Molniya value while the resonance integrator runs
        from planetmapper_tpu.kernels import sgp4

        pk = self._packet(
            95100.5, 0.0, 63.4, 120.0, 0.700, 270.0, 10.0, 2.0056,
        )
        params = sgp4.sgp4_init_packets(self.CONSTANTS, pk)
        assert params['irez'][0] == 2.0
        mu = 398600.8
        for t_days in (-5.0, 0.0, 1.0, 5.0, 20.0):
            s = self._propagate(pk, t_days * 1440.0)
            r = np.linalg.norm(s[:3])
            v = np.linalg.norm(s[3:])
            a = 1.0 / (2.0 / r - v * v / mu)
            assert 26400.0 < a < 26700.0, (t_days, a)

    def test_deep_space_jit_vmap(self):
        # The resonance integrator is a fixed-length masked scan: the whole
        # deep-space path must trace under jit with batched times
        import jax

        from planetmapper_tpu.kernels import sgp4

        pk = self._packet(
            95100.5, 0.0, 0.0300, 80.0, 0.0002, 30.0, 200.0, 1.00273790,
        )
        params = sgp4.sgp4_init_packets(self.CONSTANTS, pk)
        ets = pk[0, 9] + np.linspace(0.0, 86400.0, 16)
        fn = jax.jit(
            lambda e: sgp4.tle_state_j2000_at_index(
                self.CONSTANTS, params, np.zeros(16, dtype=int), e
            )
        )
        out = np.asarray(fn(ets))
        assert out.shape == (16, 6)
        assert np.isfinite(out).all()
        # jit result matches the eager per-time evaluation
        one = np.asarray(
            sgp4.tle_state_j2000_at_index(
                self.CONSTANTS, params, 0, float(ets[3])
            )
        )
        np.testing.assert_allclose(out[3], one, rtol=0, atol=1e-6)

    def test_near_earth_unaffected_by_deep_code(self):
        # A mixed segment (near-earth packet evaluated through params that
        # carry deep-space machinery) must produce identical results to a
        # pure near-earth segment
        from planetmapper_tpu.kernels import sgp4

        pk_ne = self._packet(
            80275.98708465, 0.66816e-4, 72.8435, 115.9689, 0.0086731,
            52.6988, 110.5714, 16.05824518,
        )
        pk_deep = self._packet(
            95100.5, 0.0, 0.0300, 80.0, 0.0002, 30.0, 200.0, 1.00273790,
        )
        mixed = np.concatenate([pk_ne, pk_deep])
        params_mixed = sgp4.sgp4_init_packets(self.CONSTANTS, mixed)
        params_pure = sgp4.sgp4_init_packets(self.CONSTANTS, pk_ne)
        assert params_mixed['_has_deep']
        et = pk_ne[0, 9] + 360.0 * 60.0
        s_mixed = np.asarray(
            sgp4.tle_state_j2000_at_index(
                self.CONSTANTS, params_mixed, 0, et
            )
        )
        s_pure = np.asarray(
            sgp4.tle_state_j2000_at_index(
                self.CONSTANTS, params_pure, 0, et
            )
        )
        np.testing.assert_allclose(s_mixed, s_pure, rtol=0, atol=1e-9)
