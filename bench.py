#!/usr/bin/env python3
"""
Benchmark of the main path on one GPU:

1. Full default backplane set at 2048x2048 (Mpix/s) through
   ``compute_backplanes``. CPU reference point: the reference's
   ~80 us/pixel scalar CSPICE loop (~0.0125 Mpix/s, BASELINE.md).
2. Map reprojection: Jupiter observation -> 1440x720 equirectangular
   ``map_img``, linear/cubic/smooth, ms/frame (BASELINE config 4).
3. Ephemeris-time batch: backplanes vmapped over many observation
   epochs, ms/frame (BASELINE config 5).

Run from the repository root: ``python bench.py``. Inputs are the seeded
synthetic kernel set unless ``PLANETMAPPER_KERNEL_PATH`` names another.
Every timing ends in ``jax.block_until_ready``. Exits non-zero without a
GPU. Prints one JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BASELINE_MPIX_PER_S = 0.0125  # reference CPU loop (BASELINE.md)


def _timed(fn, *args, **kwargs):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def bench_backplanes(size: int, n_runs: int) -> dict:
    from planetmapper_tpu import BodyXY
    from planetmapper_tpu.pipeline import compute_backplanes

    t_setup0 = time.perf_counter()
    body = BodyXY(
        'Jupiter', observer='EARTH', utc='2005-01-01T00:00:00', sz=size
    )
    body.set_disc_params(size / 2, size / 2, size * 0.4, 12.3)
    setup_time = time.perf_counter() - t_setup0

    t_compile0 = time.perf_counter()
    for _ in range(2):
        out, _ = _timed(compute_backplanes, body, as_numpy=False)
        # disc parameters are traced arguments: no recompile
        body.adjust_disc_params(dx=0.25)
    compile_time = time.perf_counter() - t_compile0

    times = []
    for _ in range(n_runs):
        body.adjust_disc_params(dx=0.1)
        out, t = _timed(compute_backplanes, body, as_numpy=False)
        times.append(t)
    blocked_best = min(times)

    # Pipelined: enqueue n_runs full sets, then wait for all of them
    import jax

    t0 = time.perf_counter()
    outs = []
    for _ in range(n_runs):
        body.adjust_disc_params(dx=0.1)
        outs.append(compute_backplanes(body, as_numpy=False))
    jax.block_until_ready(outs)
    per_call = (time.perf_counter() - t0) / n_runs

    best = min(blocked_best, per_call)
    return {
        'mpix_per_s': size * size / 1e6 / best,
        'full_set_ms': best * 1e3,
        'blocked_call_ms': blocked_best * 1e3,
        'pipelined_call_ms': per_call * 1e3,
        'all_times_ms': [t * 1e3 for t in times],
        'n_backplanes': len(out),
        'setup_s': setup_time,
        'warmup_s': compile_time,
    }


def bench_map(n_runs: int) -> dict:
    from planetmapper_tpu import BodyXY

    map_kwargs = {'projection': 'rectangular', 'degree_interval': 0.25}
    rng = np.random.default_rng(0)
    out = {}
    for size in (150, 1024):
        body = BodyXY(
            'Jupiter', observer='EARTH', utc='2005-01-01T00:00:00', sz=size
        )
        body.set_disc_params(size / 2, size / 2, size * 0.4, 12.3)
        # x/y map generation is cached across frames (as in get_mapped_data)
        body.get_x_map(**map_kwargs)
        body.get_y_map(**map_kwargs)
        n_stream = max(n_runs * 4, 16)
        for interp in ('linear', 'cubic', 'smooth'):
            img = rng.normal(size=(size, size))
            m, _ = _timed(body.map_img, img, interpolation=interp,
                          **map_kwargs)
            assert m.shape == (720, 1440), m.shape
            # map_img returns device-resident maps and dispatches
            # asynchronously, so a stream of fresh frames pipelines
            frames = [rng.normal(size=(size, size)) for _ in range(n_stream)]
            import jax

            t0 = time.perf_counter()
            ms = [body.map_img(f, interpolation=interp, **map_kwargs)
                  for f in frames]
            jax.block_until_ready(ms)
            out[f'map_{interp}_{size}_ms_per_frame'] = (
                (time.perf_counter() - t0) / n_stream * 1e3
            )
            # one cube: all frames in ONE batched device program
            cube = rng.normal(size=(16, size, size))
            _timed(body.map_img, cube, interpolation=interp, **map_kwargs)
            _, t = _timed(body.map_img, cube * 1.000001,
                          interpolation=interp, **map_kwargs)
            out[f'map_{interp}_{size}_cube_ms_per_frame'] = t / 16 * 1e3
    return out


def bench_time_batch(n_frames: int) -> dict:
    from planetmapper_tpu import BodyXY
    from planetmapper_tpu.parallel import backplane_time_series

    size = 50
    body = BodyXY(
        'Jupiter', observer='EARTH', utc='2005-01-01T00:00:00', sz=size
    )
    body.set_disc_params(size / 2, size / 2, size * 0.4, 0.0)
    ets = body.et + 60.0 * np.arange(n_frames)
    names = ['EMISSION', 'LON-GRAPHIC']
    # warm with the same batch size (the vmapped program is shape-static)
    _timed(backplane_time_series, body, ets, names=names, as_numpy=False)
    out, elapsed = _timed(
        backplane_time_series, body, ets + 30.0, names=names, as_numpy=False
    )
    assert out['EMISSION'].shape == (n_frames, size, size)
    t0 = time.perf_counter()
    fetched = {k: np.asarray(v) for k, v in out.items()}
    fetch_s = time.perf_counter() - t0
    assert fetched['EMISSION'].shape == (n_frames, size, size)
    return {
        'cube_frames': n_frames,
        'cube_ms_per_frame': elapsed / n_frames * 1e3,
        'cube_total_s': elapsed,
        'cube_fetch_s': fetch_s,
    }


def main() -> int:
    import jax

    if jax.default_backend() != 'gpu':
        print(f'bench: no GPU (JAX backend {jax.default_backend()!r})',
              file=sys.stderr)
        return 2

    import planetmapper_tpu as pm
    from chip_smoke import card_info
    from planetmapper_tpu.kernels.synthetic import ensure_kernel_set

    if not os.environ.get('PLANETMAPPER_KERNEL_PATH'):
        pm.set_kernel_path(ensure_kernel_set())

    size = int(os.environ.get('BENCH_SIZE', '2048'))
    n_runs = int(os.environ.get('BENCH_RUNS', '8'))
    cube_frames = int(os.environ.get('BENCH_CUBE_FRAMES', '1000'))

    dev = jax.devices()[0]
    detail = {
        'size': size, 'platform': dev.platform, 'device_kind': dev.device_kind,
        'device_count': len(jax.devices()), 'card': card_info(),
    }
    bp = bench_backplanes(size, n_runs)
    detail.update(bp)
    detail.update(bench_map(n_runs))
    detail.update(bench_time_batch(cube_frames))

    mpix_per_s = bp['mpix_per_s']
    print(json.dumps({
        'metric': (
            'Backplane Mpix/sec (2048^2 full default set); '
            'map reprojection ms/frame'
        ),
        'value': mpix_per_s,
        'unit': 'Mpix/s',
        'vs_baseline': mpix_per_s / BASELINE_MPIX_PER_S,
        'detail': detail,
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
