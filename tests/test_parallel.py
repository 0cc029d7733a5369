"""
Multi-chip sharding and gradient disc-fitting tests, run on the virtual
8-device CPU mesh (conftest sets xla_force_host_platform_device_count=8).
"""

import numpy as np
import pytest

from common import setup_kernels

from planetmapper_tpu import BodyXY
from planetmapper_tpu.parallel import (
    fit_disc_gradient,
    make_mesh,
    make_training_step,
    sharded_backplanes,
)


@pytest.fixture(scope='module', autouse=True)
def kernels():
    setup_kernels()


class TestMesh:
    def test_make_mesh(self):
        import jax

        mesh = make_mesh()
        assert mesh.shape['px'] == len(jax.devices())
        mesh4 = make_mesh(4)
        assert mesh4.shape['px'] == 4


class TestShardedBackplanes:
    def test_matches_unsharded(self):
        body = BodyXY('Jupiter', utc='2005-01-01', nx=16, ny=12)
        body.set_disc_params(8, 6, 5, 10.0)
        mesh = make_mesh(4)
        sharded = sharded_backplanes(body, mesh)
        fused = body.generate_backplanes_fused()
        assert set(sharded.keys()) == set(fused.keys())
        for name in fused:
            a = np.asarray(sharded[name])
            b = np.asarray(fused[name])
            assert a.shape == b.shape, name
            # The illumination angles run in f32 (half-angle form, see
            # pipeline.py); XLA reassociates f32 chains differently for
            # the sharded row-block shapes, so those planes agree only to
            # a few f32 ulps (~1e-5 deg) - well inside the pipeline's
            # 5e-5 deg illumination budget. Everything else is f64-backed
            # and matches to 1e-9.
            atol = (
                5e-5 if name in ('PHASE', 'INCIDENCE', 'EMISSION', 'AZIMUTH')
                else 1e-9
            )
            np.testing.assert_allclose(a, b, atol=atol, equal_nan=True)

    def test_uneven_rows_padded(self):
        body = BodyXY('Jupiter', utc='2005-01-01', nx=10, ny=7)
        body.set_disc_params(5, 3.5, 3, 0.0)
        mesh = make_mesh(8)
        sharded = sharded_backplanes(body, mesh)
        assert np.asarray(sharded['EMISSION']).shape == (7, 10)


    def test_program_cached_across_calls(self):
        from planetmapper_tpu.parallel import sharding

        body = BodyXY('Jupiter', utc='2005-01-01', nx=16, ny=12)
        body.set_disc_params(8, 6, 4, 0.0)
        mesh = make_mesh(4)
        first = sharded_backplanes(body, mesh)
        n_programs = len(sharding._SHARDED_CACHE)
        body.set_disc_params(7.5, 6.5, 4.2, 10.0)
        second = sharded_backplanes(body, mesh)
        assert len(sharding._SHARDED_CACHE) == n_programs
        assert not np.array_equal(
            np.asarray(first['EMISSION']), np.asarray(second['EMISSION']),
            equal_nan=True,
        )


class TestShardedMapImg:
    @pytest.mark.parametrize('interpolation', ['linear', 'cubic'])
    def test_matches_unsharded(self, interpolation):
        from planetmapper_tpu.parallel import sharded_map_img

        body = BodyXY('Jupiter', utc='2005-01-01', nx=20, ny=16)
        body.set_disc_params(10, 8, 7, 15.0)
        rng = np.random.default_rng(5)
        img = rng.normal(size=(16, 20)).cumsum(axis=0)
        img[4, 7] = np.nan
        kwargs = {'projection': 'rectangular', 'degree_interval': 10}
        mesh = make_mesh(4)
        sharded = sharded_map_img(
            body, img, mesh, interpolation=interpolation, **kwargs
        )
        reference = np.asarray(body.map_img(
            img, interpolation=interpolation, **kwargs
        ))
        assert sharded.shape == reference.shape  # (18, 36) rows uneven->pad
        assert np.array_equal(np.isnan(sharded), np.isnan(reference))
        np.testing.assert_allclose(
            np.nan_to_num(sharded), np.nan_to_num(reference), atol=1e-5
        )


class TestGradientFit:
    def test_fit_recovers_disc(self):
        # Render a synthetic disc with known parameters, then recover them
        truth = (15.0, 13.0, 9.0)
        body = BodyXY('Jupiter', utc='2005-01-01', nx=30, ny=26)
        body.set_disc_params(*truth, 0.0)
        emission = np.asarray(body.get_backplane_img('EMISSION'))
        data = np.where(np.isfinite(emission), 1.0, 0.0)

        body.set_disc_params(truth[0] + 2.5, truth[1] - 2.0, truth[2] * 1.3, 0.0)
        x0, y0, r0, rot = fit_disc_gradient(
            body, data, n_steps=200, learning_rate=0.1
        )
        assert x0 == pytest.approx(truth[0], abs=0.3)
        assert y0 == pytest.approx(truth[1], abs=0.3)
        assert r0 == pytest.approx(truth[2], abs=0.3)
        assert body.get_disc_method() == 'fit_gradient'

    def test_training_step_sharded(self):
        import jax
        from jax.sharding import Mesh

        body = BodyXY('Jupiter', utc='2005-01-01', nx=16, ny=16)
        body.set_disc_params(8, 8, 6, 0.0)
        devices = np.array(jax.devices()[:8]).reshape(2, 4)
        mesh = Mesh(devices, ('data', 'px'))
        data = np.zeros((4, 16, 16))
        data[:, 4:12, 4:12] = 1.0
        step, params, opt_state = make_training_step(body, data, mesh=mesh)
        losses = []
        for _ in range(5):
            params, opt_state, loss = step(params, opt_state)
            losses.append(float(loss))
        assert all(np.isfinite(losses))
        assert losses[-1] <= losses[0]


class TestTimeSeries:
    def test_batched_times(self):
        from planetmapper_tpu.parallel import backplane_time_series

        body = BodyXY('Jupiter', utc='2005-01-01T00:00:00', nx=12, ny=10)
        body.set_disc_params(6, 5, 4, 0.0)
        times = [
            '2005-01-01T00:00:00', '2005-01-01T01:00:00',
            '2005-01-01T02:00:00',
        ]
        out = backplane_time_series(
            body, times, names=['EMISSION', 'LON-GRAPHIC']
        )
        assert out['EMISSION'].shape == (3, 10, 12)
        fused = body.generate_backplanes_fused()
        # EMISSION runs in f32 (see pipeline.py); the vmapped time-batch
        # shapes reassociate the f32 chain differently, so agreement is a
        # few f32 ulps (~1e-5 deg), inside the 5e-5 deg budget
        np.testing.assert_allclose(
            out['EMISSION'][0], fused['EMISSION'], atol=5e-5, equal_nan=True
        )
        # Jupiter rotates ~36.27 deg of W longitude per hour
        lon0, lon1 = out['LON-GRAPHIC'][0], out['LON-GRAPHIC'][1]
        both = np.isfinite(lon0) & np.isfinite(lon1)
        d = np.mod((lon1 - lon0)[both] + 180, 360) - 180
        assert np.median(d) == pytest.approx(36.27, abs=0.05)

    def test_sharded_over_time(self):
        from planetmapper_tpu.parallel import backplane_time_series

        body = BodyXY('Jupiter', utc='2005-01-01T00:00:00', nx=8, ny=8)
        body.set_disc_params(4, 4, 3, 0.0)
        mesh = make_mesh(4, axis_names=('data',))
        times = [f'2005-01-01T0{i}:00:00' for i in range(4)]
        out = backplane_time_series(body, times, names=['EMISSION'], mesh=mesh)
        assert out['EMISSION'].shape == (4, 8, 8)


class TestMultihost:
    def test_initialize_single_process_noop(self):
        from planetmapper_tpu.parallel import initialize_distributed

        initialize_distributed()  # single process: must be a no-op

    def test_multihost_mesh_and_shardings(self):
        import jax

        from planetmapper_tpu.parallel import (
            frame_sharding,
            make_multihost_mesh,
            pixel_row_sharding,
        )

        mesh = make_multihost_mesh()
        assert mesh.axis_names == ('frames', 'px')
        assert mesh.devices.size == len(jax.devices())
        assert mesh.shape['frames'] == max(1, jax.process_count())
        fs = frame_sharding(mesh)
        ps = pixel_row_sharding(mesh)
        assert fs.spec[0] == 'frames'
        assert ps.spec[1] == 'px'

    def test_time_series_on_multihost_mesh(self):
        import numpy as np

        from planetmapper_tpu import BodyXY
        from planetmapper_tpu.parallel import (
            backplane_time_series,
            make_mesh,
            make_multihost_mesh,
        )

        body = BodyXY('Jupiter', utc='2005-01-01T00:00:00', nx=8, ny=8)
        body.set_disc_params(4, 4, 3, 0.0)
        # single process: the 'frames' axis has size 1, so shard over px
        mesh = make_mesh(8, axis_names=('data',))
        times = [body.et + 60.0 * i for i in range(8)]
        out = backplane_time_series(body, times, names=['EMISSION'], mesh=mesh)
        assert out['EMISSION'].shape == (8, 8, 8)
        assert np.isfinite(out['EMISSION']).any()


class TestTimeSeriesDiscChange:
    def test_disc_params_not_baked_into_cache(self):
        """Regression: the vmapped anchors program must not bake disc
        parameters (it is cached on the shared engine)."""
        import numpy as np

        from planetmapper_tpu import BodyXY
        from planetmapper_tpu.parallel import backplane_time_series

        body = BodyXY('Jupiter', utc='2005-01-01T00:00:00', nx=12, ny=12)
        body.set_disc_params(6, 6, 5, 0.0)
        times = [body.et, body.et + 60.0]
        backplane_time_series(body, times, names=['EMISSION'])
        body.set_disc_params(5.0, 5.0, 4.0, 20.0)
        out = backplane_time_series(body, times, names=['EMISSION'])
        ref = body.generate_backplanes_fused()['EMISSION']
        # Stale baked-in disc params would produce a different disc mask
        assert np.array_equal(
            np.isnan(out['EMISSION'][0]), np.isnan(ref)
        )
        both = np.isfinite(ref)
        # Extreme-grazing edge pixels amplify ~1e-15 anchor differences,
        # so compare the well-conditioned interior
        interior = both & (ref < 85.0)
        np.testing.assert_allclose(
            out['EMISSION'][0][interior], ref[interior], atol=1e-4
        )
