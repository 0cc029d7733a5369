"""
Double-single ("two-float") arithmetic, for accelerators without native
float64.

Where float64 is missing (or emulated as pairs of float32 words, ~49
effective mantissa bits), code that needs the pipeline's "f64-grade"
precision can carry values as explicit ``(hi, lo)`` float32 pairs and use
the classic error-free transformations (Dekker/Knuth, cf. the CUDA/QD
"double-single" libraries) implemented here. Results round-trip
losslessly through :func:`from_f64` / :func:`to_f64`. The pipeline selects
it only with ``PLANETMAPPER_TPU_DS=ds`` (see
:func:`planetmapper_tpu.pipeline.pick_ds`); by default it uses the
native-float64 :mod:`.ds64` with the same call surface.

Design rules:

- Every value is a ``(hi, lo)`` tuple of same-shape float32 arrays with
  the normalisation invariant ``|lo| <= ulp(hi)/2`` (maintained by a
  trailing ``quick_two_sum`` in every op).
- ``two_prod`` uses Dekker splitting (the 12-bit-half products are exact
  in float32 regardless of FMA contraction, so the sequence is safe under
  any compiler reassociation of multiplies into FMAs).
- Magnitude domain: |x| < ~8e34 (the split constant 2^12+1 must not
  overflow) and |x| > ~1e-37 for the Newton seeds - ample for the
  pipeline's km/s/rad quantities, same bounds as :mod:`.fastmath`.
- NaN propagates through every op (the pipeline's not-found convention).

Everything is shape-polymorphic elementwise jnp code, usable in any
jitted program (the unit tests check it against numpy float64).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_SPLIT = 4097.0  # 2^12 + 1 (Dekker split constant for float32)

F32 = jnp.float32


def two_sum(a, b):
    """Error-free sum of two f32: ``a + b = s + err`` exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Error-free sum assuming ``|a| >= |b|`` (3 flops)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product of two f32: ``a * b = p + err`` exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ---------------------------------------------------------------------------
# ds construction / conversion


def const(x):
    """Python float -> ds constant (exact split via float64 host math)."""
    hi = jnp.float32(x)
    lo = jnp.float32(x - float(hi))
    return hi, lo


def from_f32(x):
    return x, jnp.zeros_like(x)


def from_f64(x):
    """f64 array -> (hi, lo) f32 pair (exact; inverse of :func:`to_f64`).

    The pair is passed through an optimization barrier: XLA's
    excess-precision convert-folding rewrites ``f32(a64) op f32(b64)``
    into ``f32(a64 op64 b64)``, which evaluates downstream f32 chains
    in f64 and rounds ONCE - exactly the transformation that nulls
    every error-free-transformation term this library relies on
    (observed on an XLA:CPU build as context-dependent
    ulp(largest-term)-grade collapses of recentred 1e9-km chains). The
    barrier makes the split words opaque f32 values the simplifier
    cannot trace back to converts.
    """
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return lax.optimization_barrier((hi, lo))


def to_f64(d):
    """(hi, lo) -> f64 array (exact: hi and lo are representable)."""
    return d[0].astype(jnp.float64) + d[1].astype(jnp.float64)


def hi(d):
    """Collapse-proof f32 value of a ds pair (use instead of ``d[0]``).

    Consuming ONLY the hi word of a ds chain lets fast-math-enabled
    backends reassociate the error-free-transformation sums away - the
    chain then evaluates as naive f32, observed in this stack as
    context-dependent ~ulp(largest-term) errors (tens of km on
    recentred 1e9-km chains). Empirically only fusions ROOTED at an
    f64 value compile strictly, so the pair is combined to f64 and an
    optimization barrier pins that combine as the fusion root before
    converting back; the f32 value is recovered exactly
    (``|lo| <= ulp(hi)/2`` makes the rounded combine equal hi).
    Costs one f64 add + two converts + a fusion break per use.
    """
    return lax.optimization_barrier(to_f64(d)).astype(F32)


# ---------------------------------------------------------------------------
# arithmetic


def neg(a):
    return -a[0], -a[1]


def add(a, b):
    """Accurate ds + ds (Knuth two-sum chain; exact under cancellation)."""
    s, e = two_sum(a[0], b[0])
    t, f = two_sum(a[1], b[1])
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return quick_two_sum(s, e)


def sub(a, b):
    return add(a, neg(b))


def add_f(a, b):
    """ds + f32."""
    s, e = two_sum(a[0], b)
    e = e + a[1]
    return quick_two_sum(s, e)


def sub_f(a, b):
    return add_f(a, -b)


def mul(a, b):
    """ds * ds (ignores lo*lo, error ~2^-49 relative)."""
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return quick_two_sum(p, e)


def mul_f(a, b):
    """ds * f32."""
    p, e = two_prod(a[0], b)
    e = e + a[1] * b
    return quick_two_sum(p, e)


def recip_seed(x):
    """~f32-accurate 1/x without any float division.

    A plain ``1.0 / x`` seed is NOT safe here: fast-math-enabled
    backends both (a) lower f32 division to an approximate reciprocal
    (rcpps-class, ~2^-12 relative) and (b) symbolically fold pure-f32
    Newton refinements ``r*(2 - x*r)`` around a division back INTO the
    division - observed in this stack as context-dependent ~1e-8-grade
    ds.recip results that no added f32 Newton step could repair. The
    magic-constant exponent-flip seed below is integer arithmetic, so
    no simplifier can connect it to a division; three Newton steps
    bring its ~0.05 relative error to the f32 rounding floor
    deterministically (0.05 -> 2.5e-3 -> 6e-6 -> ~2^-24).

    Domain: positive-range magnitudes in ~[1e-37, 1e37]; x = 0 or inf
    produce garbage finite/NaN values (callers clamp, as they must for
    plain division too); NaN propagates.
    """
    ax = jnp.abs(x)
    bits = lax.bitcast_convert_type(ax, jnp.int32)
    r = lax.bitcast_convert_type(jnp.int32(0x7EF311C3) - bits, F32)
    r = jnp.where(x < 0, -r, r)
    for _ in range(3):
        r = r * (F32(2.0) - x * r)
    return r


def recip(a):
    """1/a in ds via division-free f32 seed + one ds Newton step.

    ~2^-47 relative; see :func:`recip_seed` for why the seed must not
    be a float division. Domain: |a| in ~[1e-37, 1e37]; NaN
    propagates, a = +-0 yields NaN (not inf) - callers clamp zeros.
    """
    r0 = recip_seed(a[0])
    # r = r0 * (2 - a*r0): the seed's 2^-24 error squares
    ar = mul_f(a, r0)
    d = add_f(neg(ar), F32(2.0))
    return mul_f(d, r0)


def div(a, b):
    return mul(a, recip(b))


def rsqrt(a):
    """1/sqrt(a) in ds: f32 ``lax.rsqrt`` seed + one f32 NR + one ds NR.

    The extra f32 Newton step makes the result independent of how
    approximate the hardware rsqrt is (accelerators may lower
    ``lax.rsqrt`` to a fast approximate op); final error ~2^-47
    relative. a <= 0 or NaN
    propagates NaN (except +0 -> +inf seeds, which the callers clamp).
    """
    x = a[0]
    r0 = lax.rsqrt(x)
    r0 = r0 * (F32(1.5) - F32(0.5) * x * r0 * r0)  # f32 NR: seed -> ~1 ulp
    # ds NR: r = r0 + r0*(1 - a*r0^2)/2
    r0sq = two_prod(r0, r0)
    ar2 = mul(a, r0sq)
    h = mul_f(add_f(neg(ar2), F32(1.0)), F32(0.5))
    corr = mul_f(h, r0)
    return add_f(corr, r0)


def sqrt(a):
    """sqrt(a) for a >= 0 in ds; 0 -> 0, negative/NaN -> NaN."""
    pos = a[0] > 0.0
    safe = (jnp.where(pos, a[0], F32(1.0)), jnp.where(pos, a[1], F32(0.0)))
    r = mul(safe, rsqrt(safe))
    zero = jnp.zeros_like(a[0])
    nan = jnp.full_like(a[0], jnp.nan)
    neg_or_nan = ~pos & (a[0] != 0.0)  # negative or NaN (NaN != 0 is True)
    hi = jnp.where(pos, r[0], jnp.where(neg_or_nan, nan, zero))
    lo = jnp.where(pos, r[1], zero)
    return hi, lo


# ---------------------------------------------------------------------------
# 3-vector helpers (components as separate ds values)


def dot3(ax, ay, az, bx, by, bz):
    return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz))


def matvec3(m, vx, vy, vz):
    """(3,3) ds matrix (nested tuples) @ ds 3-vector -> 3 ds components."""
    return tuple(
        add(add(mul(m[i][0], vx), mul(m[i][1], vy)), mul(m[i][2], vz))
        for i in range(3)
    )
