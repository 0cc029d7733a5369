"""
The main path runs without matplotlib and Pillow: BodyXY, the fused
backplanes, map_img, backplane_time_series and FITS save/load (without the
wireframe) import and run with both blocked, and code that needs them
raises a clear ImportError. Runs in a subprocess, because the blocker must
be in place before the package is first imported.
"""

import os
import subprocess
import sys

from common import KERNEL_PATH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import importlib.abc
import sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('matplotlib', 'PIL'):
            raise ModuleNotFoundError(f'No module named {name!r} (blocked)')
        return None


sys.meta_path.insert(0, Block())

import os
import tempfile

import numpy as np

import planetmapper_tpu as pm
from planetmapper_tpu.parallel import backplane_time_series
from planetmapper_tpu.pipeline import compute_backplanes

pm.set_kernel_path(sys.argv[1])
body = pm.BodyXY('Jupiter', observer='EARTH', utc='2005-01-01', sz=24)
body.set_disc_params(12, 12, 9, 10.0)
planes = compute_backplanes(body)
assert len(planes) == 26 and np.isfinite(planes['EMISSION']).any()
img = np.random.default_rng(0).random((24, 24))
for mode in ('linear', 'smooth'):
    m = np.asarray(body.map_img(img, interpolation=mode, degree_interval=10))
    assert m.shape == (18, 36) and np.isfinite(m).any(), mode
ts = backplane_time_series(body, [body.et, body.et + 60.0],
                           names=['EMISSION'])
assert ts['EMISSION'].shape == (2, 24, 24)

obs = pm.Observation(data=np.ones((2, 24, 24)), target='Jupiter',
                     utc='2005-01-01', observer='EARTH')
obs.set_disc_params(12, 12, 9, 0.0)
with tempfile.TemporaryDirectory() as td:
    path = os.path.join(td, 'nav.fits')
    obs.save_observation(path, print_info=False, include_wireframe=False)
    assert pm.Observation(path).get_disc_method() == 'header'

for call in (
    lambda: body.plot_wireframe_radec(show=False),
    lambda: pm.Observation(os.path.join(td, 'image.png'), target='Jupiter',
                           utc='2005-01-01'),
):
    try:
        call()
    except ImportError as exc:
        assert 'blocked' in str(exc) or 'install' in str(exc), exc
    else:
        raise AssertionError('expected ImportError')
assert not any(
    m.split('.')[0] in ('matplotlib', 'PIL') for m in sys.modules
)
print('OK')
'''


def test_main_path_without_matplotlib_and_pil():
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, '-c', SCRIPT, KERNEL_PATH],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith('OK')
