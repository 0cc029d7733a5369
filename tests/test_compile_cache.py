"""
Where the persistent compilation cache lands: in JAX_COMPILATION_CACHE_DIR
when it is set (the package then sets no directory itself), otherwise in
.jax_cache beside the package. Each case runs in a fresh interpreter,
because the cache is configured when the package is imported.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = '''
import jax, planetmapper_tpu
print(jax.config.jax_compilation_cache_dir)
print(planetmapper_tpu.CACHE_DIR_DEFAULT)
'''


def _cache_dirs(env_dir):
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    env.pop('JAX_COMPILATION_CACHE_DIR', None)
    if env_dir is not None:
        env['JAX_COMPILATION_CACHE_DIR'] = env_dir
    proc = subprocess.run(
        [sys.executable, '-c', SCRIPT], env=env, capture_output=True,
        text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split()


def test_env_var_wins(tmp_path):
    configured, default = _cache_dirs(str(tmp_path))
    assert configured == str(tmp_path)
    assert default == os.path.join(REPO, '.jax_cache')


def test_fixed_path_in_checkout():
    configured, default = _cache_dirs(None)
    assert configured == default == os.path.join(REPO, '.jax_cache')
    assert os.path.isdir(configured)
