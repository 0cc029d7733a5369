"""
Mixed-precision building blocks for the fused pipeline's ``'mixed'`` mode.

Written for accelerators that emulate float64 in software, where the
emulated *transcendentals* (sin/atan2) and div/sqrt cost ~10-40x a float64
multiply while float32 ops are effectively free. These helpers give
near-float64 results using only float64 multiplies/adds plus a float32
seed:

- ``recip64`` / ``rsqrt64`` / ``sqrt64``: float32 reciprocal / rsqrt seed
  refined with ONE Newton-Raphson step carried out in float64 arithmetic.
  Quadratic convergence squares the 24-bit seed's error to ~2^-48, i.e.
  ~3e-15 relative - ample for every pipeline use (the tightest consumer
  needs ~1e-10), but NOT full float64: quantities needing ~1e-16 relative
  (e.g. anything feeding LOCAL-SOLAR-TIME's quantization boundaries) must
  use real f64 ops instead.
- ``div64``: quotient with a residual correction (~1 ulp).
- ``norm3_64`` / ``normalize3_64``: 3-vector norms built on the above.

NaN inputs propagate to NaN everywhere (the pipeline's not-found
convention relies on it).

Everything here is shape-polymorphic elementwise jnp code.
"""

from __future__ import annotations

import jax.numpy as jnp


def recip64(x):
    """1/x in near-float64 accuracy without an emulated f64 divide.

    The f32 seed requires |x| in ~[1e-37, 1e37]; callers guard/clamp
    degenerate denominators (as the plain-division pipeline variants guard
    division by zero anyway).
    """
    from .ds import recip_seed

    # Division-free f32 seed (integer magic + 3 Newton steps): immune
    # to fast-math backends lowering f32 division approximately and/or
    # folding same-precision Newton refinements back into the division
    # (see ds.recip_seed). The f64 Newton step below crosses precision,
    # which no simplifier folds, and squares the 24-bit seed's error to
    # ~2^-48, i.e. ~3e-15 relative - ample for every pipeline use
    # (needs ~1e-10 at most).
    r = recip_seed(x.astype(jnp.float32)).astype(jnp.float64)
    r = r * (2.0 - x * r)
    return r


def div64(num, den):
    """num/den via :func:`recip64` with a final residual correction."""
    r = recip64(den)
    q = num * r
    # One residual step so the quotient (not just the reciprocal) is
    # correctly rounded to ~1 ulp
    return q + (num - den * q) * r


def rsqrt64(x):
    """1/sqrt(x) in near-float64 accuracy without an emulated f64 sqrt.

    The f32 seed requires x in ~[1e-37, 3e37]; out-of-range magnitudes
    are clamped CONSISTENTLY (seed and Newton step), so huge x yields a
    finite positive (inaccurate) value rather than inf or a sign flip.
    Negative x and NaN propagate NaN.
    """
    import jax.lax as lax

    xc = jnp.clip(x, 1e-37, 3e37)
    seed = xc.astype(jnp.float32)
    r32 = lax.rsqrt(seed)
    # f32 NR first: hardware rsqrt seeds are approximate (table-based,
    # ~2^-12..2^-14); this step makes the seed ~24-bit regardless
    r32 = r32 * (
        jnp.float32(1.5) - jnp.float32(0.5) * seed * r32 * r32
    )
    r = r32.astype(jnp.float64)
    r = r * (1.5 - 0.5 * xc * r * r)  # ~3e-15 relative after the f64 NR
    return jnp.where(x < 0.0, jnp.nan, r)  # NaN compares False: stays NaN


def sqrt64(x):
    """sqrt(x) for x >= 0 (near-float64 accuracy, f32 seed + NR in mults).

    Returns 0.0 for x == 0 and for negative x (rsqrt overflows at 0;
    negatives are the caller's responsibility to mask - matching how the
    plain pipeline clamps discriminants before sqrt). NaN propagates.
    """
    r = rsqrt64(jnp.where(x > 0.0, x, 1.0))
    out = jnp.where(x > 0.0, x * r, 0.0)
    return jnp.where(jnp.isnan(x), jnp.nan, out)


def dot3(a, b):
    return (
        a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    )


def norm3_64(v):
    return sqrt64(dot3(v, v))


def normalize3_64(v):
    return v * rsqrt64(dot3(v, v))[..., None]
