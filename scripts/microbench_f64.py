#!/usr/bin/env python3
"""
Microbenchmark: float64 vs double-single (ops/ds.py) vs f32 elementwise
arithmetic on the default JAX device, plus transcendental costs.

Grounds the mixed-precision design of the fused pipeline in measured op
costs (docs/performance.md): each case times a chain of K dependent ops
over an (N, N) grid, pipelined (dispatch R executions, force the last),
so the per-op cost is (time - baseline) / K / pixels.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = int(os.environ.get('MB_N', '2048'))
K = int(os.environ.get('MB_K', '64'))
R = int(os.environ.get('MB_R', '8'))


def timed(fn, *args) -> float:
    # every fn returns a device scalar, so fetching it waits for the
    # device and keeps a large D2H copy out of the measurement
    out = fn(*args)
    float(out)
    best = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(R - 1):
            out = fn(*args)
        out = fn(*args)
        float(out)
        best = min(best, (time.perf_counter() - t0) / R)
    return best


def main() -> None:
    import jax
    import jax.numpy as jnp

    from planetmapper_tpu.ops import ds

    print(f'device={jax.devices()[0]}  N={N}  K={K}', flush=True)

    x64 = jnp.asarray(np.random.default_rng(0).uniform(0.5, 2.0, (N, N)))
    x32 = x64.astype(jnp.float32)

    # constants with no algebraic shortcuts
    a = 1.0000001
    b = 1e-7

    def _s(v):
        return jnp.sum(v[::256, ::256])

    @jax.jit
    def base32(x):
        return _s(x + 1.0)

    @jax.jit
    def fma32(x):
        for _ in range(K):
            x = x * a + b
        return _s(x)

    @jax.jit
    def fma64(x):
        for _ in range(K):
            x = x * a + b
        return _s(x)

    @jax.jit
    def mul64(x):
        for _ in range(K):
            x = x * a
        return _s(x)

    @jax.jit
    def add64(x):
        for _ in range(K):
            x = x + b
        return _s(x)

    ca = ds.const(a)
    cb = ds.const(b)

    @jax.jit
    def fma_ds(x):
        d = ds.from_f64(x)
        for _ in range(K):
            d = ds.add_f(ds.mul(d, ca), np.float32(b))
        return _s(ds.to_f64(d))

    @jax.jit
    def mul_ds(x):
        d = ds.from_f64(x)
        for _ in range(K):
            d = ds.mul(d, ca)
        return _s(ds.to_f64(d))

    @jax.jit
    def mulf_ds(x):
        d = ds.from_f64(x)
        for _ in range(K):
            d = ds.mul_f(d, np.float32(a))
        return _s(ds.to_f64(d))

    @jax.jit
    def add_ds(x):
        d = ds.from_f64(x)
        for _ in range(K):
            d = ds.add(d, cb)
        return _s(ds.to_f64(d))

    kt = max(1, K // 8)

    @jax.jit
    def atan2_64(x):
        y = x
        for _ in range(kt):
            y = jnp.arctan2(y, x + 1.0)
        return _s(y)

    @jax.jit
    def atan2_32(x):
        y = x
        for _ in range(kt):
            y = jnp.arctan2(y, x + 1.0)
        return _s(y)

    @jax.jit
    def sincos_64(x):
        y = x
        for _ in range(kt):
            y = jnp.sin(y) + jnp.cos(y)
        return _s(y)

    @jax.jit
    def sqrt_64(x):
        y = x
        for _ in range(kt):
            y = jnp.sqrt(y + 1.0)
        return _s(y)

    @jax.jit
    def div_64(x):
        y = x
        for _ in range(kt):
            y = y / (x + 1.0) + 1.0
        return _s(y)

    base_t = timed(base32, x32)
    rows = [
        ('f32 fma', fma32, x32, K),
        ('f64 fma', fma64, x64, K),
        ('f64 mul', mul64, x64, K),
        ('f64 add', add64, x64, K),
        ('ds mul', mul_ds, x64, K),
        ('ds mul_f', mulf_ds, x64, K),
        ('ds add(const)', add_ds, x64, K),
        ('ds fma', fma_ds, x64, K),
        ('f64 atan2', atan2_64, x64, kt),
        ('f32 atan2', atan2_32, x32, kt),
        ('f64 sin+cos', sincos_64, x64, kt),
        ('f64 sqrt', sqrt_64, x64, kt),
        ('f64 div', div_64, x64, kt),
    ]
    print(f'{"baseline (1 f32 add)":>22s}: {base_t * 1e3:9.3f} ms total')
    f32_fma = None
    for name, fn, arg, k in rows:
        t = timed(fn, arg)
        per_op_ps = (t - base_t) / k / (N * N) * 1e12
        note = ''
        if name == 'f32 fma':
            f32_fma = per_op_ps
        elif f32_fma and per_op_ps > 0:
            note = f'  ({per_op_ps / f32_fma:6.1f}x f32 fma)'
        print(
            f'{name:>22s}: {t * 1e3:9.3f} ms total, '
            f'{per_op_ps:9.1f} ps/op/pixel{note}',
            flush=True,
        )


if __name__ == '__main__':
    main()
