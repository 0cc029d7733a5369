#!/usr/bin/env python3
"""
Per-section cost attribution for the fused backplane pipeline.

Times jitted wrappers that reduce a cumulative subset of planes to one
scalar (fetched to the host, which waits for the device; XLA
dead-code-eliminates unselected planes). The delta between successive
rows attributes cost to each pipeline section.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZE = int(os.environ.get('PROF_SIZE', '2048'))

SECTIONS: list[tuple[str, list[str]]] = [
    ('pixel/affine', ['PIXEL-X', 'PIXEL-Y', 'KM-X', 'KM-Y',
                      'ANGULAR-X', 'ANGULAR-Y']),
    ('radec', ['RA', 'DEC']),
    ('intercept+lonlat', ['LON-GRAPHIC', 'LAT-GRAPHIC']),
    ('centric', ['LON-CENTRIC', 'LAT-CENTRIC']),
    ('illumination', ['PHASE', 'INCIDENCE', 'EMISSION']),
    ('azimuth', ['AZIMUTH']),
    ('lst', ['LOCAL-SOLAR-TIME']),
    ('state', ['DISTANCE', 'RADIAL-VELOCITY', 'DOPPLER']),
    ('limb', ['LIMB-DISTANCE', 'LIMB-LON-GRAPHIC', 'LIMB-LAT-GRAPHIC']),
    ('ring', ['RING-RADIUS', 'RING-LON-GRAPHIC', 'RING-DISTANCE']),
]


def main() -> None:
    import jax
    import jax.numpy as jnp

    import planetmapper_tpu
    from planetmapper_tpu import BodyXY
    from planetmapper_tpu.kernels.synthetic import ensure_kernel_set
    from planetmapper_tpu.pipeline import fused_backplanes_fn

    if not os.environ.get('PLANETMAPPER_KERNEL_PATH'):
        planetmapper_tpu.set_kernel_path(ensure_kernel_set())

    body = BodyXY(
        'Jupiter', observer='EARTH', utc='2005-01-01T00:00:00', sz=SIZE
    )
    body.set_disc_params(SIZE / 2, SIZE / 2, SIZE * 0.4, 12.3)
    anchors = body._get_pipeline_anchors()
    impl = fused_backplanes_fn(
        positive_west=body.positive_longitude_direction == 'W',
        prograde=body.prograde,
        have_sun=True,
        optimize_speed=bool(body._optimize_speed),
        precision=os.environ.get('PROF_PRECISION', 'mixed'),
    )
    args = jax.device_put((
        np.asarray(body._get_xy2angular_matrix()),
        np.asarray(body.get_disc_params(), dtype=np.float64),
        np.asarray(body.radii, dtype=np.float64),
        anchors,
    ))

    TILED = os.environ.get('PROF_TILED', '1') not in ('0', 'off')
    BAND = int(os.environ.get('PROF_BAND', '256'))

    def time_fn(keys):
        def wrapped(xy2angular, disc, radii, anchors):
            if TILED:
                from jax import lax

                n_bands = SIZE // BAND

                def band(i):
                    row0 = (i * BAND).astype(jnp.float64)
                    return impl(SIZE, BAND, xy2angular, disc, radii,
                                anchors, row0=row0)

                out = lax.map(band, jnp.arange(n_bands))
            else:
                out = impl(SIZE, SIZE, xy2angular, disc, radii, anchors)
            return sum(jnp.nansum(out[k]) for k in keys)

        fn = jax.jit(wrapped)
        float(fn(*args))  # warm + force
        # Pipelined timing: dispatch N executions back-to-back and force
        # only the last scalar, so the dispatch and fetch latency
        # amortises to 1/N and the per-call figure approaches pure device
        # execution time.
        n = int(os.environ.get('PROF_REPS', '8'))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n - 1):
                fn(*args)
            float(fn(*args))
            times.append((time.perf_counter() - t0) / n)
        return min(times) * 1e3

    print(f'size={SIZE}  device={jax.devices()[0]}', flush=True)
    # Baseline: trivial forced scalar, measures launch + D2H latency
    base = time_fn(['PIXEL-X'])
    print(f'{"latency baseline":>22s}: {base:8.1f} ms (PIXEL-X only)',
          flush=True)
    keys: list[str] = []
    prev = base
    for name, section_keys in SECTIONS:
        keys = keys + section_keys
        t = time_fn(keys)
        print(f'{name:>22s}: {t:8.1f} ms  (delta {t - prev:+8.1f})',
              flush=True)
        prev = t


if __name__ == '__main__':
    main()
