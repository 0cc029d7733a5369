"""
Fused-pipeline validation: the single-program backplane pipeline must match
the exact per-plane getters (which in turn match CSPICE via the FITS
regression tests).
"""

import numpy as np
import pytest

from common import setup_kernels

from planetmapper_tpu import BodyXY


@pytest.fixture(scope='module', autouse=True)
def kernels():
    setup_kernels()


# Per-plane absolute tolerances for fused vs exact comparison. Angle planes
# agree to ~1e-5 deg (linearisation truncation); km-valued distance planes
# to tens of metres out of ~8e8 km (grazing-incidence light-time
# convergence jitter, relative ~3e-11).
# (atol, rtol) per plane: km-valued planes grow with distance, so a
# relative term applies (same semantics as the FITS regression comparison)
TOLS = {
    'DISTANCE': (0.05, 5e-7),
    'RING-DISTANCE': (0.05, 5e-7),
    'RING-RADIUS': (0.05, 5e-7),
    'KM-X': (1e-4, 2e-7),
    'KM-Y': (1e-4, 2e-7),
    'LIMB-DISTANCE': (1e-4, 2e-7),
    # mm/s-level: the fused pipeline's f32 velocity algebra rounds at
    # ~6e-8 of the ~30 km/s state magnitudes (still 3 orders of magnitude
    # inside the 2e-5 km/s FITS regression contract)
    'RADIAL-VELOCITY': (1e-5, 0.0),
}


def _on_disc_boundary(mask):
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


def _compare(body):
    fused = body.generate_backplanes_fused()
    assert set(fused.keys()) == set(body.backplanes.keys())
    for name, bp in body.backplanes.items():
        exact = np.asarray(bp.get_img())
        f = fused[name]
        mask_diff = np.isnan(exact) != np.isnan(f)
        if mask_diff.any():
            # Knife-edge pixels: where the intercept discriminant sits at
            # f64-noise level, found/not-found legitimately flips between
            # two valid evaluation orders. Allow mismatches only ON the
            # limb boundary, and only a handful of them.
            boundary = _on_disc_boundary(np.isnan(exact))
            assert np.all(boundary[mask_diff]), (
                f'{name}: NaN masks differ off the disc boundary'
            )
            assert mask_diff.sum() <= max(2, exact.size // 64), (
                f'{name}: too many boundary NaN mismatches'
            )
        both = np.isfinite(exact) & np.isfinite(f)
        if not both.any():
            continue
        diff = np.abs(exact[both] - f[both])
        if 'LON' in name:
            diff = np.minimum(diff, 360.0 - diff)
        atol, rtol = TOLS.get(name, (5e-5, 0.0))
        tol = atol + rtol * np.abs(exact[both])
        assert np.all(diff < tol), f'{name}: max excess {np.max(diff - tol)}'


class TestAnchorSpec:
    def test_abstract_spec_matches_real_anchors(self):
        # The AOT precompile path (get_fused_pipeline) traces against
        # this static spec so the pipeline compile can overlap the
        # anchor computation on cold start; drift would silently waste
        # that warmup (the jit path re-traces), so pin it here.
        from planetmapper_tpu.pipeline import _anchor_abstract_spec

        body = BodyXY(
            'Jupiter', observer='EARTH', utc='2005-01-01T00:00:00', sz=8
        )
        real = body._get_pipeline_anchors()
        spec = _anchor_abstract_spec()
        assert set(spec) == set(real)
        for k, s in spec.items():
            v = np.asarray(real[k])
            assert v.shape == s.shape, k
            assert v.dtype == s.dtype, k

    def test_precompiled_matches_jit(self):
        # the AOT executable and the jit path must produce the same
        # program: precompile, call (served by the executable), then
        # disable it and call again via jit - identical results
        from planetmapper_tpu.pipeline import (
            compute_backplanes,
            get_fused_pipeline,
        )

        body = BodyXY('Jupiter', utc='2005-01-01', sz=16)
        body.set_disc_params(8, 8, 6, 0.0)
        out1 = compute_backplanes(body)  # cold path runs precompile
        fn = get_fused_pipeline(body, 16, 16)
        assert hasattr(fn, 'precompile')
        out2 = compute_backplanes(body)
        for k in out1:
            np.testing.assert_array_equal(out1[k], out2[k], err_msg=k)


class TestFusedPipeline:
    @pytest.fixture(autouse=True, params=['double', 'mixed'])
    def precision(self, request, monkeypatch):
        # both numeric modes of the fused pipeline: 'double' (default)
        # and the f32 'mixed' mode (PLANETMAPPER_TPU_PRECISION=mixed)
        from planetmapper_tpu import pipeline

        monkeypatch.setattr(pipeline, 'DEFAULT_PRECISION', request.param)
        return request.param

    def test_matches_exact_hst(self):
        body = BodyXY(
            'Jupiter', observer='HST', utc='2005-01-01T00:00:00', nx=15, ny=10
        )
        body.set_disc_params(7, 4.5, 4, 20.0)
        _compare(body)

    def test_matches_exact_earth(self):
        body = BodyXY('Jupiter', utc='2005-01-01', nx=12, ny=12)
        body.set_disc_params(6, 6, 5, 0.0)
        _compare(body)

    def test_matches_exact_saturn(self):
        body = BodyXY('Saturn', utc='2000-01-01', nx=10, ny=10)
        body.set_disc_params(5, 5, 3, 45.0)
        _compare(body)

    def test_matches_exact_satellite(self):
        # BASELINE config 2 shape: a satellite target (distinct radii,
        # rotation model and prograde sense from the planet configs).
        # Amalthea: the committed test SPK covers the inner jovian moons.
        body = BodyXY('Amalthea', utc='2005-01-01', nx=14, ny=11)
        body.set_disc_params(7, 5.5, 4.5, 30.0)
        _compare(body)

    def test_matches_exact_full_disc_with_caps(self):
        # Disc filling the frame: the sub-solar/sub-observer caps (where
        # sin(incidence)/sin(emission) -> 0 and the azimuth projections
        # cancel catastrophically) are on-disc, exercising the
        # double-single azimuth path against the exact f64 pipeline
        body = BodyXY('Jupiter', utc='2005-01-01', nx=96, ny=96)
        body.set_disc_params(48, 48, 40, 10.0)
        _compare(body)

    def test_batch_matches_per_frame(self):
        from planetmapper_tpu.pipeline import (
            compute_backplanes,
            compute_backplanes_batch,
        )

        body = BodyXY('Jupiter', utc='2005-01-01', nx=12, ny=12)
        disc_sets = [
            (6.0, 6.0, 5.0, 0.0),
            (5.5, 6.2, 4.8, 12.0),
            (7.0, 5.0, 3.5, 120.0),
        ]
        mats, discs, singles = [], [], []
        for params in disc_sets:
            body.set_disc_params(*params)
            mats.append(body._get_xy2angular_matrix())
            discs.append(params)
            singles.append(compute_backplanes(body))
        batched = compute_backplanes_batch(body, mats, discs)
        assert set(batched.keys()) == set(singles[0].keys())
        for name, arr in batched.items():
            assert arr.shape == (len(disc_sets), 12, 12)
            for i, single in enumerate(singles):
                np.testing.assert_array_equal(
                    arr[i], single[name], err_msg=f'{name}[{i}]'
                )

    def test_disc_param_change_no_recompile(self):
        from planetmapper_tpu import pipeline

        body = BodyXY('Jupiter', utc='2005-01-01', nx=12, ny=12)
        body.set_disc_params(6, 6, 5, 0.0)
        body.generate_backplanes_fused()
        n_compiled = len(pipeline._PIPELINE_CACHE)
        body.set_disc_params(5.5, 6.2, 4.8, 12.0)
        _compare(body)
        assert len(pipeline._PIPELINE_CACHE) == n_compiled

    def test_plane_subset(self):
        from planetmapper_tpu.pipeline import compute_backplanes

        body = BodyXY('Jupiter', utc='2005-01-01', nx=16, ny=16)
        body.set_disc_params(8, 8, 6, 3.0)
        full = compute_backplanes(body)
        names = ('EMISSION', 'LON-GRAPHIC', 'RING-RADIUS')
        sub = compute_backplanes(body, names=names)
        assert set(sub) == set(names)
        for name in names:
            np.testing.assert_array_equal(
                sub[name], full[name], err_msg=name
            )
        with pytest.raises(ValueError, match='unknown planes'):
            compute_backplanes(body, names=('NOT-A-PLANE',))


class TestPrecisionSelection:
    def test_pick_ds_is_native_f64(self, monkeypatch):
        from planetmapper_tpu.ops import ds, ds64
        from planetmapper_tpu.pipeline import pick_ds

        monkeypatch.delenv('PLANETMAPPER_TPU_DS', raising=False)
        assert pick_ds() is ds64
        monkeypatch.setenv('PLANETMAPPER_TPU_DS', 'ds')
        assert pick_ds() is ds

    def test_pick_ds_ignores_backend(self, monkeypatch):
        import jax

        from planetmapper_tpu.ops import ds64
        from planetmapper_tpu.pipeline import pick_ds

        monkeypatch.delenv('PLANETMAPPER_TPU_DS', raising=False)
        monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')
        assert pick_ds() is ds64

