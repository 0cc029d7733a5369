#!/usr/bin/env python3
"""
Smoke test of planetmapper_tpu's main path on a GPU, through the public API.

Run from the repository root:

    python chip_smoke.py           # phases A-C on one GPU
    python chip_smoke.py --multi   # the parallel API on four GPUs, only

Phases (one process; any failure exits non-zero):

- A, backplanes: Jupiter from Earth at 2005-01-01, 2048x2048, disc radius
  0.4 * size, all 26 default planes through ``compute_backplanes``; a cold
  call, then 5 warm calls with changed disc parameters; every plane
  compared with the exact per-plane getters (``body.backplanes[n]
  .get_img()``).
- B, maps: a 1024x1024 source navigated like A, mapped to the 1440x720
  rectangular map at 0.25 deg with linear, cubic and smooth
  interpolation, for one frame and a 16-frame cube; compared with the
  host scipy/FITPACK evaluator.
- C, time series: ``backplane_time_series`` with every default plane at
  256x256 over 200 epochs one minute apart; 3 epochs compared with
  per-frame ``compute_backplanes``.

``--multi`` runs only ``sharded_backplanes`` at 4096x4096, phase C sharded
over time, and one disc-fit training step on a 2x2 ('data', 'px') mesh,
each compared with its one-device result.

Inputs are the seeded synthetic kernel set
(:mod:`planetmapper_tpu.kernels.synthetic`) and images made from
``--seed``. Every timing line carries the card's name and power limit.
The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``. Without a GPU
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

import planetmapper_tpu as pm
from planetmapper_tpu.kernels.synthetic import ensure_kernel_set

UTC = '2005-01-01T00:00:00'

#: Precision each comparison runs at, printed with the results.
PRECISION_NOTE = (
    'device f32 contractions on the main path run at '
    'lax.Precision.HIGHEST (explicit in the library); f64 contractions '
    'and the per-plane getters are native float64; map references are '
    'host float64 scipy/FITPACK'
)

#: Per-plane (atol, rtol) of the fused pipeline against the exact
#: per-plane getters; planes not listed use (5e-5 deg, 0).
PLANE_TOLS = {
    # km-valued distances: tens of metres out of ~8e8 km, from grazing-
    # incidence light-time convergence jitter (relative ~3e-11)
    'DISTANCE': (0.05, 5e-7),
    'RING-DISTANCE': (0.05, 5e-7),
    'RING-RADIUS': (0.05, 5e-7),
    # target-plane km: f32 output rounding of ~1e5 km values
    'KM-X': (1e-4, 2e-7),
    'KM-Y': (1e-4, 2e-7),
    'LIMB-DISTANCE': (1e-4, 2e-7),
    # mm/s: the fused pipeline's f32 velocity algebra rounds at ~6e-8 of
    # the ~30 km/s state magnitudes
    'RADIAL-VELOCITY': (1e-5, 0.0),
}
#: Angles: the anchor linearisation truncates at ~1e-5 deg.
DEFAULT_PLANE_TOL = (5e-5, 0.0)

#: Map tolerances against host scipy/FITPACK (tests/test_shells.py):
#: the device evaluates the spline basis and the PCHIP sampler in f32, a
#: ~1e-5 px effective sample-position rounding; the smooth mode's tiled
#: sampler carries the looser bound of its tiled test.
MAP_TOLS = {'linear': 2e-5, 'cubic': 2e-5, 'smooth': 2e-4}


def card_info() -> str:
    """``name, power.limit`` of the first GPU, as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return f'null ({type(exc).__name__}: {exc})'
    return out[0] if out else 'null (nvidia-smi printed nothing)'


class CompileMeter:
    """Backend compile seconds and persistent-cache hits, from JAX events."""

    def __init__(self) -> None:
        import jax

        self.seconds = 0.0
        self.hits = 0
        self.misses = 0
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)

    def _duration(self, event: str, duration: float, **_) -> None:
        if event == '/jax/core/compile/backend_compile_duration':
            self.seconds += duration

    def _event(self, event: str, **_) -> None:
        if event == '/jax/compilation_cache/cache_hits':
            self.hits += 1
        elif event == '/jax/compilation_cache/cache_misses':
            self.misses += 1

    def snapshot(self) -> tuple[float, int, int]:
        return self.seconds, self.hits, self.misses

    def since(self, snap) -> str:
        s, h, m = snap
        return (
            f'compile_s={self.seconds - s:.3f} cache_hits={self.hits - h} '
            f'cache_misses={self.misses - m}'
        )


def timed(fn, *args, **kwargs):
    """``(result, seconds)`` of a call that ends when its arrays are ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def _on_disc_boundary(mask: np.ndarray) -> np.ndarray:
    """Pixels 8-adjacent to an on/off-disc transition of ``mask``."""
    padded = np.pad(mask, 1, mode='edge')
    out = np.zeros_like(mask)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out |= (
                padded[1 + dy : 1 + dy + mask.shape[0],
                       1 + dx : 1 + dx + mask.shape[1]]
                != mask
            )
    return out


def compare_planes(test: dict, reference: dict, label: str,
                   per_plane: bool = True) -> list[str]:
    """
    Check every plane of ``test`` against ``reference``: NaN masks may
    differ only on the disc edge (where the intercept discriminant sits
    at float64 noise, found/not-found flips between two valid evaluation
    orders) and only in a handful of pixels; finite values within
    :data:`PLANE_TOLS`. Returns one report line per plane, or with
    ``per_plane=False`` one line for all of them.
    """
    assert set(test) == set(reference), (label, set(test) ^ set(reference))
    lines = []
    worst = (0.0, '')
    n_edge = 0
    for name in sorted(reference):
        ref = np.asarray(reference[name], dtype=np.float64)
        val = np.asarray(test[name], dtype=np.float64)
        assert ref.shape == val.shape, (label, name, ref.shape, val.shape)
        mask_diff = np.isnan(ref) != np.isnan(val)
        n_diff = int(mask_diff.sum())
        if n_diff:
            boundary = _on_disc_boundary(np.isnan(ref))
            assert np.all(boundary[mask_diff]), (
                f'{label} {name}: NaN masks differ off the disc edge'
            )
            assert n_diff <= max(2, ref.size // 64), (
                f'{label} {name}: {n_diff} NaN mask mismatches'
            )
        both = np.isfinite(ref) & np.isfinite(val)
        err = 0.0
        if both.any():
            diff = np.abs(ref[both] - val[both])
            if 'LON' in name:
                diff = np.minimum(diff, 360.0 - diff)
            atol, rtol = PLANE_TOLS.get(name, DEFAULT_PLANE_TOL)
            excess = diff - (atol + rtol * np.abs(ref[both]))
            assert np.all(excess < 0), (
                f'{label} {name}: max excess over tolerance '
                f'{float(excess.max())}'
            )
            err = float(diff.max())
            ratio = float(np.max(diff / (atol + rtol * np.abs(ref[both]))))
            worst = max(worst, (ratio, name))
        n_edge += n_diff
        agree = 1.0 - n_diff / ref.size
        lines.append(
            f'{label} {name}: max_abs_err={err:.3e} '
            f'tol={PLANE_TOLS.get(name, DEFAULT_PLANE_TOL)} '
            f'nan_mask_agreement={agree:.7f} ({n_diff} edge px)'
        )
    if per_plane:
        return lines
    return [
        f'{label}: all {len(reference)} planes within tolerance; largest '
        f'err/tol {worst[0]:.3f} ({worst[1]}); {n_edge} edge px differ '
        'in NaN mask'
    ]


def _navigated(size: int):
    body = pm.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=size)
    body.set_disc_params(size / 2, size / 2, 0.4 * size, 0.0)
    return body


def phase_backplanes(size: int = 2048, warm_calls: int = 5,
                     card: str = '', meter: CompileMeter | None = None):
    """Phase A; returns report lines."""
    from planetmapper_tpu.pipeline import compute_backplanes

    snap = meter.snapshot() if meter else None
    body = _navigated(size)
    _, cold = timed(compute_backplanes, body, as_numpy=False)
    lines = [
        f'[A] backplanes {size}x{size} cold_s={cold:.4f} '
        + (meter.since(snap) if meter else '') + f' card={card}'
    ]
    warm = []
    for i in range(1, warm_calls + 1):
        body.set_disc_params(
            size / 2 + 1.5 * i, size / 2 - 0.5 * i,
            0.4 * size * (1.0 + 0.01 * i), 3.0 * i,
        )
        out, t = timed(compute_backplanes, body, as_numpy=False)
        warm.append(t)
    lines.append(
        f'[A] warm_s={[round(t, 6) for t in warm]} '
        f'median_warm_s={float(np.median(warm)):.6f} card={card}'
    )
    exact = {n: bp.get_img() for n, bp in body.backplanes.items()}
    assert len(exact) == 26, len(exact)
    lines += compare_planes(out, exact, '[A]')
    return lines


def _source_image(size: int, n_frames: int, seed: int) -> np.ndarray:
    """Smooth pattern plus small noise, with a NaN patch per frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    frames = []
    for i in range(n_frames):
        f = np.sin(xx / 37.0 + 0.3 * i) * np.cos(yy / 53.0 - 0.2 * i)
        f += 0.02 * rng.standard_normal((size, size))
        y0 = (size // 3 + 7 * i) % (size - 8)
        f[y0 : y0 + 5, size // 2 : size // 2 + 6] = np.nan
        frames.append(f)
    return np.stack(frames)


def _host_map(mode: str, frame, x_map, y_map) -> np.ndarray:
    from planetmapper_tpu.ops import interp

    out = np.full(x_map.shape, np.nan)
    if mode == 'smooth':
        interp.smooth_interpolation(
            frame, x_map, y_map, out, propagate_nan=True,
            oversample_by=5, max_oversampled_img_size=10_000,
        )
    else:
        interp.spline_interpolation(
            frame, x_map, y_map, out,
            interpolation={'linear': 1, 'cubic': 3}[mode],
            warn_nan=False, propagate_nan=True, spline_smoothing=0,
        )
    return out


def _check_map(mode, label, val, ref, lines, card):
    val = np.asarray(val, dtype=np.float64)
    assert val.shape == ref.shape, (label, val.shape, ref.shape)
    assert np.array_equal(np.isnan(val), np.isnan(ref)), (
        f'{label}: NaN masks differ from the host reference'
    )
    finite = np.isfinite(ref)
    assert finite.any(), f'{label}: empty map'
    err = float(np.max(np.abs(val[finite] - ref[finite])))
    assert err < MAP_TOLS[mode], f'{label}: max_abs_err {err}'
    lines.append(
        f'{label} max_abs_err={err:.3e} tol={MAP_TOLS[mode]} '
        f'nan_mask_agreement=1.0 valid_px={int(finite.sum())} card={card}'
    )


def phase_maps(src: int = 1024, degree_interval: float = 0.25,
               n_frames: int = 16, seed: int = 0, card: str = '',
               meter: CompileMeter | None = None):
    """Phase B; returns report lines."""
    body = _navigated(src)
    cube = _source_image(src, n_frames, seed)
    x_map = np.asarray(body.get_x_map(degree_interval=degree_interval))
    y_map = np.asarray(body.get_y_map(degree_interval=degree_interval))
    lines = [f'[B] source {src}x{src} map {x_map.shape} cube {n_frames}']
    for mode in ('linear', 'cubic', 'smooth'):
        snap = meter.snapshot() if meter else None
        one, cold = timed(
            body.map_img, cube[0], interpolation=mode,
            degree_interval=degree_interval,
        )
        _, warm = timed(
            body.map_img, cube[1], interpolation=mode,
            degree_interval=degree_interval,
        )
        many, cube_cold = timed(
            body.map_img, cube, interpolation=mode,
            degree_interval=degree_interval,
        )
        _, cube_warm = timed(
            body.map_img, cube[::-1].copy(), interpolation=mode,
            degree_interval=degree_interval,
        )
        lines.append(
            f'[B] {mode} frame cold_s={cold:.4f} warm_s={warm:.6f} '
            f'cube cold_s={cube_cold:.4f} warm_s={cube_warm:.6f} '
            f'warm_ms_per_frame={1e3 * cube_warm / n_frames:.4f} '
            + (meter.since(snap) if meter else '') + f' card={card}'
        )
        ref0 = _host_map(mode, cube[0], x_map, y_map)
        _check_map(mode, f'[B] {mode} frame', one, ref0, lines, card)
        many = np.asarray(many)
        _check_map(mode, f'[B] {mode} cube[0]', many[0], ref0, lines, card)
        last = n_frames - 1
        ref_last = _host_map(mode, cube[last], x_map, y_map)
        _check_map(
            mode, f'[B] {mode} cube[{last}]', many[last], ref_last, lines,
            card,
        )
    return lines


def _epochs(n: int) -> list[str]:
    base = np.datetime64('2005-01-01T00:00:00')
    return [
        str(base + np.timedelta64(i, 'm')) for i in range(n)
    ]


def phase_time_series(size: int = 256, n_epochs: int = 200,
                      checks: tuple[int, ...] = (0, 99, 199),
                      card: str = '', meter: CompileMeter | None = None,
                      mesh=None):
    """Phase C (``mesh`` shards it over time); returns report lines."""
    from planetmapper_tpu.parallel import backplane_time_series
    from planetmapper_tpu.pipeline import compute_backplanes

    times = _epochs(n_epochs)
    body = _navigated(size)
    snap = meter.snapshot() if meter else None
    series, cold = timed(
        backplane_time_series, body, times, mesh=mesh, as_numpy=False
    )
    _, warm = timed(
        backplane_time_series, body, times, mesh=mesh, as_numpy=False
    )
    tag = '[C]' if mesh is None else '[multi C]'
    lines = [
        f'{tag} time series {n_epochs} x {size}x{size} x {len(series)} '
        f'planes cold_s={cold:.4f} warm_s={warm:.6f} '
        f'warm_ms_per_epoch={1e3 * warm / n_epochs:.4f} '
        + (meter.since(snap) if meter else '') + f' card={card}'
    ]
    for i in checks:
        frame_body = pm.BodyXY('Jupiter', observer='EARTH', utc=times[i],
                               sz=size)
        frame_body.set_disc_params(size / 2, size / 2, 0.4 * size, 0.0)
        ref = compute_backplanes(frame_body)
        got = {k: np.asarray(v[i]) for k, v in series.items()}
        lines += compare_planes(
            got, ref, f'{tag} epoch {i} vs per-frame', per_plane=False
        )
    return lines, series


def phase_multi(card: str = '', meter: CompileMeter | None = None,
                size: int = 4096, series_size: int = 256,
                n_epochs: int = 200, fit_size: int = 256):
    """``--multi``: the parallel API on four devices vs one device."""
    import jax
    from jax.sharding import Mesh

    from planetmapper_tpu.parallel import (
        make_mesh,
        make_training_step,
        sharded_backplanes,
    )
    from planetmapper_tpu.pipeline import compute_backplanes

    assert len(jax.devices()) >= 4, f'--multi needs 4 devices: {jax.devices()}'
    mesh = make_mesh(4)
    lines = []

    body = _navigated(size)
    snap = meter.snapshot() if meter else None
    sharded, cold = timed(sharded_backplanes, body, mesh)
    _, warm = timed(sharded_backplanes, body, mesh)
    lines.append(
        f'[multi A] sharded_backplanes {size}x{size} on 4 cold_s={cold:.4f} '
        f'warm_s={warm:.6f} ' + (meter.since(snap) if meter else '')
        + f' card={card}'
    )
    single, t1 = timed(compute_backplanes, body, as_numpy=False)
    _, t1_warm = timed(compute_backplanes, body, as_numpy=False)
    lines.append(
        f'[multi A] one device {size}x{size} cold_s={t1:.4f} '
        f'warm_s={t1_warm:.6f} card={card}'
    )
    lines += compare_planes(
        sharded, single, '[multi A] 4 devices vs 1', per_plane=False
    )

    mesh_t = make_mesh(4, axis_names=('data',))
    kwargs = dict(size=series_size, n_epochs=n_epochs, checks=(),
                  card=card, meter=meter)
    four_lines, four = phase_time_series(mesh=mesh_t, **kwargs)
    one_lines, one = phase_time_series(**kwargs)
    lines += four_lines + one_lines
    for i in sorted({0, n_epochs // 2, n_epochs - 1}):
        lines += compare_planes(
            {k: np.asarray(v[i]) for k, v in four.items()},
            {k: np.asarray(v[i]) for k, v in one.items()},
            f'[multi C] epoch {i} 4 devices vs 1', per_plane=False,
        )

    body = _navigated(fit_size)
    yy, xx = np.mgrid[0:fit_size, 0:fit_size]
    disc = (
        (xx - 0.51 * fit_size) ** 2 + (yy - 0.49 * fit_size) ** 2
        < (0.39 * fit_size) ** 2
    ).astype(float)
    data = np.stack([disc] * 4)
    results = {}
    for name, devs in (('one', (1, 1)), ('2x2', (2, 2))):
        devices = np.array(jax.devices()[: devs[0] * devs[1]]).reshape(devs)
        step, params, opt_state = make_training_step(
            body, data, mesh=Mesh(devices, ('data', 'px'))
        )
        (params1, _, loss), cold = timed(step, params, opt_state)
        _, warm = timed(step, params, opt_state)
        results[name] = (np.asarray(params1), float(loss))
        lines.append(
            f'[multi fit] {name} mesh step cold_s={cold:.4f} '
            f'warm_s={warm:.6f} loss={float(loss):.9f} card={card}'
        )
    (p1, l1), (p4, l4) = results['one'], results['2x2']
    assert np.isfinite(l4) and abs(l4 - l1) <= 1e-9 * max(abs(l1), 1.0), (
        l1, l4
    )
    np.testing.assert_allclose(p4, p1, rtol=1e-9, atol=1e-12)
    lines.append(
        f'[multi fit] 2x2 vs one device: loss diff {abs(l4 - l1):.3e}, '
        f'params max diff {float(np.max(np.abs(p4 - p1))):.3e}'
    )
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--multi', action='store_true',
                        help='run only the four-device parallel phases')
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)

    import jax

    backend = jax.default_backend()
    if backend != 'gpu':
        print(f'chip_smoke: no GPU (JAX backend {backend!r})', file=sys.stderr)
        return 2
    meter = CompileMeter()
    card = card_info()
    print(f'card: {card}')
    print(f'jax {jax.__version__} devices: {jax.devices()}')
    print(f'compile cache dir: {jax.config.jax_compilation_cache_dir}')
    print(f'precision: {PRECISION_NOTE}')
    pm.set_kernel_path(ensure_kernel_set())

    t_start = time.perf_counter()
    if args.multi:
        phases = [('multi', lambda: phase_multi(card, meter))]
    else:
        phases = [
            ('A', lambda: phase_backplanes(card=card, meter=meter)),
            ('B', lambda: phase_maps(seed=args.seed, card=card,
                                     meter=meter)),
            ('C', lambda: phase_time_series(card=card, meter=meter)[0]),
        ]
    for name, run in phases:
        snap = meter.snapshot()
        t0 = time.perf_counter()
        for line in run():
            print(line, flush=True)
        print(
            f'phase {name}: total_s={time.perf_counter() - t0:.3f} '
            f'{meter.since(snap)} card={card}', flush=True,
        )
    print(f'all phases: total_s={time.perf_counter() - t_start:.3f} '
          f'card={card}')
    dev = jax.devices()[0]
    print(json.dumps({
        'ok': True,
        'device': {
            'platform': dev.platform, 'kind': dev.device_kind,
            'count': len(jax.devices()),
        },
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
