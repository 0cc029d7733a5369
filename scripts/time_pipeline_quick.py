#!/usr/bin/env python3
"""Quick pipelined timing of the full fused set at a given size/config."""

from __future__ import annotations

import os
import sys
import time


sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

SIZE = int(os.environ.get('PROF_SIZE', '2048'))
RUNS = int(os.environ.get('PROF_RUNS', '8'))


def main() -> None:
    import jax

    import planetmapper_tpu
    from planetmapper_tpu import BodyXY
    from planetmapper_tpu.kernels.synthetic import ensure_kernel_set
    from planetmapper_tpu.pipeline import compute_backplanes

    if not os.environ.get('PLANETMAPPER_KERNEL_PATH'):
        planetmapper_tpu.set_kernel_path(ensure_kernel_set())

    body = BodyXY(
        'Jupiter', observer='EARTH', utc='2005-01-01T00:00:00', sz=SIZE
    )
    body.set_disc_params(SIZE / 2, SIZE / 2, SIZE * 0.4, 12.3)

    t0 = time.time()
    jax.block_until_ready(compute_backplanes(body, as_numpy=False))
    print(f'compile+first: {time.time() - t0:.1f}s', flush=True)

    best = float('inf')
    for _ in range(3):
        t0 = time.time()
        outs = []
        for _ in range(RUNS):
            body.adjust_disc_params(dx=0.1)
            outs.append(compute_backplanes(body, as_numpy=False))
        jax.block_until_ready(outs)
        best = min(best, (time.time() - t0) / RUNS)
    print(
        f'pipelined: {best * 1e3:.2f} ms '
        f'({SIZE * SIZE / 1e6 / best:.1f} Mpix/s)',
        flush=True,
    )


if __name__ == '__main__':
    main()
