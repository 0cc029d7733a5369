"""
Command line interface (parity with the reference's console script).

``planetmapper-tpu [file]`` launches the GUI, optionally opening an
observation immediately; ``--version`` prints the version. The extra
``--precision`` flag selects the fused-pipeline numeric mode.
"""

from __future__ import annotations

import argparse


def main(args: list[str] | None = None) -> None:
    """CLI entry point. :meta private:"""
    from . import common

    parser = argparse.ArgumentParser(
        prog='planetmapper-tpu',
        description=(
            'planetmapper_tpu: a JAX package for visualising, '
            'navigating and mapping Solar System observations. Run with '
            'no arguments to launch the graphical interface.'
        ),
    )
    parser.add_argument(
        'file_path',
        nargs='?',
        default=None,
        help='open the GUI with this FITS/image file loaded',
    )
    parser.add_argument(
        '-v', '--version',
        action='version',
        version=f'planetmapper_tpu {common.__version__}',
        help='print the version number and exit',
    )
    parser.add_argument(
        '--precision',
        choices=('mixed', 'double'),
        default=None,
        help='numeric mode for the fused backplane pipeline',
    )
    parser.add_argument(
        '--prewarm',
        nargs='*',
        metavar='SIZE',
        default=None,
        help=(
            'compile the device pipelines for the given image sizes '
            '(default: 512 1024 2048) into the persistent compilation '
            'cache, then exit. Later sessions skip the multi-minute '
            'first-touch XLA compile. Combine with --target/--observer.'
        ),
    )
    parser.add_argument(
        '--target',
        default='JUPITER',
        help='target body for --prewarm (compiled programs depend only on '
        'the image size bucket and the body\'s longitude/rotation '
        'convention, so one prewarm covers every body sharing those)',
    )
    parser.add_argument(
        '--observer',
        default='EARTH',
        help='observer body for --prewarm',
    )
    options = parser.parse_args(args)

    if options.precision is not None:
        from . import pipeline

        pipeline.DEFAULT_PRECISION = options.precision

    if options.prewarm is not None:
        sizes = [int(s) for s in options.prewarm] or [512, 1024, 2048]
        _prewarm(options.target, options.observer, sizes)
        return

    print(f'Launching planetmapper_tpu {common.__version__}', flush=True)
    from . import gui

    gui._run_gui_from_cli(options.file_path)


def _prewarm(target: str, observer: str, sizes: list[int]) -> None:
    """
    AOT cold-start prewarm: compile the fused backplane pipeline (and the
    default map-reprojection programs) for each image size into the
    persistent compilation cache, so later sessions skip the multi-minute
    first-touch XLA compile. :meta private:
    """
    import datetime
    import time

    import jax
    import numpy as np

    from . import BodyXY
    from .pipeline import compute_backplanes

    # Any epoch covered by the loaded kernels works: compiled programs
    # take the ephemeris anchors as traced arguments.
    utc = datetime.datetime(2005, 1, 1)
    for size in sizes:
        t0 = time.time()
        body = BodyXY(target, observer=observer, utc=utc, sz=size)
        body.set_disc_params(size / 2, size / 2, size * 0.4, 0.0)
        out = compute_backplanes(body, as_numpy=False)
        next(iter(out.values())).block_until_ready()
        print(
            f'prewarm {target}/{observer} {size}x{size}: fused pipeline '
            f'compiled in {time.time() - t0:.1f}s',
            flush=True,
        )
        t0 = time.time()
        img = np.zeros((size, size))
        m = body.map_img(img, interpolation='cubic', degree_interval=1)
        jax.block_until_ready(m)
        print(
            f'prewarm {size}x{size}: map reprojection compiled in '
            f'{time.time() - t0:.1f}s',
            flush=True,
        )
    cache_dir = jax.config.jax_compilation_cache_dir
    print(f'persistent cache: {cache_dir}', flush=True)
