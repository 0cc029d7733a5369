import os

# Deterministic CPU test environment with a virtual 8-device mesh, so the
# multi-device sharding paths run without accelerators.
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8'
    ).strip()
os.environ.setdefault('JAX_PLATFORMS', 'cpu')

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

import planetmapper_tpu  # noqa: E402,F401  (enables x64, compile cache)
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        'markers',
        'reference_data: compares with CSPICE goldens or reference FITS '
        'files; skips unless PLANETMAPPER_TPU_TEST_KERNELS and '
        'PLANETMAPPER_TPU_REFERENCE_DATA name the reference project\'s '
        'kernels and tests/data directory',
    )
    config.addinivalue_line(
        'markers', 'chip: needs a GPU; skips elsewhere (run by chip_smoke.py)'
    )


@pytest.fixture(autouse=True)
def _skip_without_reference_data(request):
    if request.node.get_closest_marker('reference_data') is None:
        return
    from common import have_reference_data

    if not have_reference_data():
        pytest.skip(
            'needs the reference project\'s kernels and tests/data '
            '(PLANETMAPPER_TPU_TEST_KERNELS, PLANETMAPPER_TPU_REFERENCE_DATA)'
        )


@pytest.fixture(scope='module', autouse=True)
def _clear_jax_caches_between_modules():
    # A single process accumulating hundreds of distinct compiled XLA
    # programs has crashed XLA:CPU near the end of full-suite runs;
    # dropping the jit caches between modules keeps the live-executable
    # count bounded. (See also tests/run_tests.sh for the sharded runner.)
    yield
    jax.clear_caches()
