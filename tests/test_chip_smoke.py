"""
chip_smoke.py on the CPU: its phase functions at small sizes, its plane
comparison, and its refusal to run without a GPU or outside the repository.
The GPU run itself is ``python chip_smoke.py`` on the card.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from common import setup_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(scope='module', autouse=True)
def kernels():
    setup_kernels()


def _assert_report(lines, n_min):
    assert len(lines) >= n_min
    assert all(isinstance(line, str) and line for line in lines)


def test_phase_backplanes_small():
    lines = chip_smoke.phase_backplanes(64, warm_calls=2)
    _assert_report(lines, 2 + 26)
    assert sum('nan_mask_agreement' in line for line in lines) == 26


def test_phase_maps_small():
    lines = chip_smoke.phase_maps(64, degree_interval=5, n_frames=2)
    for mode in ('linear', 'cubic', 'smooth'):
        assert sum(line.startswith(f'[B] {mode} ') for line in lines) == 4


def test_phase_time_series_small():
    lines, series = chip_smoke.phase_time_series(
        32, n_epochs=4, checks=(0, 3)
    )
    assert len(series) == 26
    assert series['EMISSION'].shape == (4, 32, 32)
    assert sum('within tolerance' in line for line in lines) == 2


def test_phase_multi_on_four_virtual_devices():
    import jax

    assert len(jax.devices()) >= 4
    lines = chip_smoke.phase_multi(
        size=32, series_size=16, n_epochs=4, fit_size=16
    )
    assert any(line.startswith('[multi A] 4 devices vs 1') for line in lines)
    assert sum('[multi C] epoch' in line for line in lines) == 3
    assert any('2x2 vs one device' in line for line in lines)


class TestComparePlanes:
    @staticmethod
    def _planes():
        rng = np.random.default_rng(0)
        disc = np.hypot(*np.mgrid[-8:8, -8:8]) < 6
        return {
            'EMISSION': np.where(disc, rng.uniform(0, 90, disc.shape),
                                 np.nan),
            'DISTANCE': np.where(disc, 8e8 + rng.uniform(0, 1e4, disc.shape),
                                 np.nan),
        }

    def test_within_tolerance(self):
        ref = self._planes()
        test = {k: v + (1e-5 if k == 'EMISSION' else 100.0)
                for k, v in ref.items()}
        lines = chip_smoke.compare_planes(test, ref, 'x')
        assert len(lines) == 2
        (summary,) = chip_smoke.compare_planes(test, ref, 'x',
                                               per_plane=False)
        assert 'all 2 planes within tolerance' in summary

    def test_value_over_tolerance_fails(self):
        ref = self._planes()
        test = dict(ref, EMISSION=ref['EMISSION'] + 1e-4)
        with pytest.raises(AssertionError, match='EMISSION'):
            chip_smoke.compare_planes(test, ref, 'x')

    def test_nan_mask_off_the_edge_fails(self):
        ref = self._planes()
        emission = ref['EMISSION'].copy()
        emission[8, 8] = np.nan  # disc centre: far from the edge
        with pytest.raises(AssertionError, match='off the disc edge'):
            chip_smoke.compare_planes(dict(ref, EMISSION=emission), ref, 'x')


def test_card_info_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv('PATH', '')
    assert chip_smoke.card_info().startswith('null (')


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(JAX_PLATFORMS='cpu', **(env_extra or {}))
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_exits_nonzero_without_gpu():
    proc = _run(['chip_smoke.py'], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert 'no GPU' in proc.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    proc = _run(['chip_smoke.py'], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
