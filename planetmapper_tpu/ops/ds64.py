"""
Native-float64 backend for the :mod:`.ds` double-single API.

Double-single (hi, lo) f32-pair arithmetic exists for accelerators
without hardware float64, where the error-free transformations in
:mod:`.ds` deliver ~2^-49 relative precision at f32 cost. On backends
WITH native f64 (CPUs, GPUs) double-single is both pointless (native f64
is one instruction) and actively unsafe: XLA's excess-precision and
fast-math passes may evaluate f32 chains with f64 intermediates or
reassociate them, which nulls every error-free transformation term
(observed as context-dependent ulp(largest-term) collapses of recentred
1e9-km chains - e.g. 64 km RING-RADIUS errors).

This module implements the exact same call surface where a "ds value"
is ``(x_float64, zero_float32)``: the hi word carries the full native
f64 value, the lo word is identically zero. All :mod:`.ds` invariants
hold trivially (|lo| <= ulp(hi)/2), precision is >= double-single's
(2^-53 vs ~2^-49), and mixed hi-word arithmetic written against the ds
API promotes cleanly under ``jax_enable_x64``.

:func:`planetmapper_tpu.pipeline.pick_ds` returns this module on every
backend (``PLANETMAPPER_TPU_DS=ds`` selects :mod:`.ds` instead).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

F32 = jnp.float32
F64 = jnp.float64


def _zero(x):
    return jnp.zeros(jnp.shape(x), F32)


def const(x):
    """Python float -> ds constant."""
    return jnp.float64(x), jnp.float32(0.0)


def from_f32(x):
    return x.astype(F64), _zero(x)


def from_f64(x):
    """f64 array -> ds value (identity on the hi word)."""
    return x, _zero(x)


def to_f64(d):
    return d[0].astype(F64)


def hi(d):
    """f32 value of a ds pair (one rounding of the exact f64 value)."""
    return d[0].astype(F32)


def neg(a):
    return -a[0], a[1]


def add(a, b):
    return a[0] + b[0], _zero(a[0] + b[0])


def sub(a, b):
    return a[0] - b[0], _zero(a[0] - b[0])


def add_f(a, b):
    """ds + f32."""
    s = a[0] + b.astype(F64)
    return s, _zero(s)


def sub_f(a, b):
    return add_f(a, -b)


def mul(a, b):
    p = a[0] * b[0]
    return p, _zero(p)


def mul_f(a, b):
    p = a[0] * b.astype(F64)
    return p, _zero(p)


def recip(a):
    return 1.0 / a[0], _zero(a[0])


def div(a, b):
    return a[0] / b[0], _zero(a[0])


def rsqrt(a):
    return lax.rsqrt(a[0].astype(F64)), _zero(a[0])


def sqrt(a):
    """sqrt with the ds convention: 0 -> 0, negative/NaN -> NaN."""
    return jnp.sqrt(a[0]), _zero(a[0])


def dot3(ax, ay, az, bx, by, bz):
    return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz))


def matvec3(m, vx, vy, vz):
    return tuple(
        add(add(mul(m[i][0], vx), mul(m[i][1], vy)), mul(m[i][2], vz))
        for i in range(3)
    )
