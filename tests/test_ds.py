"""
Unit tests for the double-single arithmetic library (ops/ds.py).

Validates every op against numpy float64 across the pipeline's magnitude
range (km-scale 1e-3..1e9, radian-scale 1e-9..1, mixed signs), the
normalisation invariant, exact f64 round-tripping, and NaN propagation.
Runs on the forced-CPU backend like the rest of the suite; the ds ops are
pure elementwise f32 jnp code, so CPU f32 semantics match any
accelerator's f32.
"""

import numpy as np

import jax
import jax.numpy as jnp

from planetmapper_tpu.ops import ds

RNG = np.random.default_rng(1234)


def _sample(n=4096, lo=1e-6, hi=1e9):
    mag = np.exp(RNG.uniform(np.log(lo), np.log(hi), n))
    sign = RNG.choice([-1.0, 1.0], n)
    return (sign * mag).astype(np.float64)


def _to_ds(x):
    return ds.from_f64(jnp.asarray(x, jnp.float64))


def _back(d):
    return np.asarray(ds.to_f64(d), np.float64)


def _rel_err(got, want):
    scale = np.maximum(np.abs(want), 1e-300)
    return np.max(np.abs(got - want) / scale)


class TestConversions:
    def test_round_trip_exact(self):
        x = _sample()
        got = _back(_to_ds(x))
        # hi+lo carries ~49 bits; f64 values round-trip to the platform's
        # own emulated-f64 precision (hi = f32(x), lo = f32(x - hi) exact)
        hi = x.astype(np.float32).astype(np.float64)
        lo = (x - hi).astype(np.float32).astype(np.float64)
        np.testing.assert_array_equal(got, hi + lo)

    def test_normalisation_invariant(self):
        x = _sample()
        h, l = _to_ds(x)
        h = np.asarray(h, np.float64)
        l = np.asarray(l, np.float64)
        ulp = np.spacing(np.abs(h).astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(l) <= 0.5 * ulp + 1e-300)

    def test_const(self):
        h, l = ds.const(np.pi)
        assert float(h) == np.float32(np.pi)
        assert abs((float(h) + float(l)) - np.pi) < 1e-14


class TestArithmetic:
    def test_add_random(self):
        a, b = _sample(), _sample()
        da, db = _back(_to_ds(a)), _back(_to_ds(b))
        got = _back(ds.add(_to_ds(a), _to_ds(b)))
        # relative to the larger operand: mixed-sign sums cancel, so the
        # guarantee is absolute (~ulp of the inputs), not relative
        err = np.abs(got - (da + db)) / np.maximum(np.abs(da), np.abs(db))
        assert np.max(err) < 2e-14

    def test_add_cancellation(self):
        # catastrophic cancellation: a + (-a*(1+eps)) must stay accurate
        a = _sample(1024, 1e3, 1e9)
        b = -a * (1.0 + 1e-9)
        got = _back(ds.add(_to_ds(a), _to_ds(b)))
        want = _back(_to_ds(a)) + _back(_to_ds(b))
        assert _rel_err(got, want) < 2e-13

    def test_sub_mixed(self):
        a, b = _sample(), _sample()
        da, db = _back(_to_ds(a)), _back(_to_ds(b))
        got = _back(ds.sub(_to_ds(a), _to_ds(b)))
        err = np.abs(got - (da - db)) / np.maximum(np.abs(da), np.abs(db))
        assert np.max(err) < 2e-14

    def test_add_f(self):
        a = _sample()
        b = _sample().astype(np.float32)
        da = _back(_to_ds(a))
        db = b.astype(np.float64)
        got = _back(ds.add_f(_to_ds(a), jnp.asarray(b)))
        err = np.abs(got - (da + db)) / np.maximum(np.abs(da), np.abs(db))
        assert np.max(err) < 2e-14

    def test_mul_random(self):
        a, b = _sample(1024, 1e-3, 1e8), _sample(1024, 1e-3, 1e8)
        da, db = _back(_to_ds(a)), _back(_to_ds(b))
        got = _back(ds.mul(_to_ds(a), _to_ds(b)))
        assert _rel_err(got, da * db) < 1e-14

    def test_mul_f(self):
        a = _sample(1024, 1e-3, 1e8)
        b = _sample(1024, 1e-3, 1e8).astype(np.float32)
        da = _back(_to_ds(a))
        got = _back(ds.mul_f(_to_ds(a), jnp.asarray(b)))
        assert _rel_err(got, da * b.astype(np.float64)) < 1e-14

    def test_recip(self):
        a = _sample(1024, 1e-6, 1e9)
        da = _back(_to_ds(a))
        got = _back(ds.recip(_to_ds(a)))
        assert _rel_err(got, 1.0 / da) < 1e-13

    def test_div(self):
        a, b = _sample(1024, 1e-3, 1e6), _sample(1024, 1e-3, 1e6)
        da, db = _back(_to_ds(a)), _back(_to_ds(b))
        got = _back(ds.div(_to_ds(a), _to_ds(b)))
        assert _rel_err(got, da / db) < 2e-13

    def test_rsqrt(self):
        a = np.abs(_sample(1024, 1e-6, 1e9))
        da = _back(_to_ds(a))
        got = _back(ds.rsqrt(_to_ds(a)))
        assert _rel_err(got, 1.0 / np.sqrt(da)) < 1e-13

    def test_sqrt(self):
        a = np.abs(_sample(1024, 1e-6, 1e9))
        da = _back(_to_ds(a))
        got = _back(ds.sqrt(_to_ds(a)))
        assert _rel_err(got, np.sqrt(da)) < 1e-13

    def test_sqrt_edge_cases(self):
        a = jnp.asarray([0.0, -1.0, np.nan], jnp.float64)
        got = _back(ds.sqrt(ds.from_f64(a)))
        assert got[0] == 0.0
        assert np.isnan(got[1])
        assert np.isnan(got[2])


class TestVectors:
    def test_dot3(self):
        comps = [_sample(1024, 1e-3, 1e8) for _ in range(6)]
        dcomps = [_back(_to_ds(c)) for c in comps]
        got = _back(ds.dot3(*[_to_ds(c) for c in comps]))
        want = (
            dcomps[0] * dcomps[3]
            + dcomps[1] * dcomps[4]
            + dcomps[2] * dcomps[5]
        )
        assert _rel_err(got, want) < 5e-13

    def test_dot3_cancellation(self):
        # near-orthogonal vectors: |result| << |terms|
        n = 1024
        ax = _sample(n, 1.0, 1e6)
        ay = _sample(n, 1.0, 1e6)
        az = np.zeros(n)
        bx = ay.copy()
        by = -ax * (1.0 + 1e-10)
        bz = np.zeros(n)
        vecs = [_back(_to_ds(v)) for v in (ax, ay, az, bx, by, bz)]
        want = vecs[0] * vecs[3] + vecs[1] * vecs[4] + vecs[2] * vecs[5]
        got = _back(
            ds.dot3(*[_to_ds(v) for v in (ax, ay, az, bx, by, bz)])
        )
        # absolute error bounded by ds rounding of the large terms
        big = np.abs(vecs[0] * vecs[3]) + np.abs(vecs[1] * vecs[4])
        assert np.max(np.abs(got - want) / big) < 1e-13

    def test_matvec3(self):
        m64 = np.asarray(RNG.normal(size=(3, 3)), np.float64)
        m = tuple(
            tuple(_to_ds(np.full(8, m64[i, j])) for j in range(3))
            for i in range(3)
        )
        v = [_sample(8, 1e-3, 1e5) for _ in range(3)]
        dv = [_back(_to_ds(c)) for c in v]
        got = [_back(g) for g in ds.matvec3(m, *[_to_ds(c) for c in v])]
        for i in range(3):
            want = sum(
                np.float64(np.float32(m64[i, j]))
                * dv[j] for j in range(3)
            )
            # matrix entries round to ds too
            want = sum(
                _back(_to_ds(np.full(8, m64[i, j]))) * dv[j]
                for j in range(3)
            )
            assert _rel_err(got[i], want) < 1e-10  # conditioning of sum


class TestNaN:
    def test_nan_propagation(self):
        nan = jnp.asarray([np.nan], jnp.float64)
        one = jnp.asarray([1.0], jnp.float64)
        for op in (ds.add, ds.sub, ds.mul, ds.div):
            assert np.isnan(_back(op(ds.from_f64(nan), ds.from_f64(one))))
            assert np.isnan(_back(op(ds.from_f64(one), ds.from_f64(nan))))
        for op in (ds.recip, ds.rsqrt, ds.sqrt):
            assert np.isnan(_back(op(ds.from_f64(nan))))


class TestJit:
    def test_ops_jit_clean(self):
        # the library must trace/jit with no surprises (it runs inside
        # Pallas kernels where every op must be jax-traceable)
        @jax.jit
        def f(x64, y64):
            a = ds.from_f64(x64)
            b = ds.from_f64(y64)
            r = ds.add(ds.mul(a, b), ds.sqrt(ds.mul(a, a)))
            return ds.to_f64(r)

        x = jnp.asarray(_sample(256, 1e-3, 1e6))
        y = jnp.asarray(_sample(256, 1e-3, 1e6))
        got = np.asarray(f(x, y))
        a = _back(_to_ds(np.asarray(x)))
        b = _back(_to_ds(np.asarray(y)))
        assert _rel_err(got, a * b + np.abs(a)) < 1e-12
