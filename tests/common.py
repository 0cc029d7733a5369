"""Shared test fixtures and helpers."""

import os

import numpy as np

from planetmapper_tpu.kernels.synthetic import ensure_kernel_set

# SPICE kernels: the seeded synthetic set generated into build/kernels/
# unless PLANETMAPPER_TPU_TEST_KERNELS names another kernel directory.
KERNEL_PATH = os.environ.get('PLANETMAPPER_TPU_TEST_KERNELS') or (
    ensure_kernel_set()
)

# The reference project's tests/data directory (CSPICE-computed goldens,
# input and output FITS files). Tests marked ``reference_data`` compare
# against it, and need the reference project's own kernels as
# PLANETMAPPER_TPU_TEST_KERNELS.
REFERENCE_DATA_PATH = os.environ.get('PLANETMAPPER_TPU_REFERENCE_DATA', '')


def have_reference_data() -> bool:
    return bool(
        os.environ.get('PLANETMAPPER_TPU_TEST_KERNELS')
        and REFERENCE_DATA_PATH
        and os.path.isdir(REFERENCE_DATA_PATH)
    )


def observation_fits() -> str:
    """
    A small seeded observation, ``build/test_data/test.fits``: a
    (10, 10, 7) cube of Jupiter seen by HST at 2005-01-01T00:00 (header
    keywords OBJECT, TELESCOP, DATE-OBS), written once per checkout.
    """
    from planetmapper_tpu.io import fits

    directory = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'build', 'test_data',
    )
    path = os.path.join(directory, 'test.fits')
    if not os.path.exists(path):
        os.makedirs(directory, exist_ok=True)
        data = np.random.default_rng(0).uniform(0.0, 1.0, (10, 10, 7))
        header = fits.Header()
        header['OBJECT'] = 'JUPITER'
        header['TELESCOP'] = 'HST'
        header['DATE-OBS'] = '2005-01-01T00:00:00'
        tmp = f'{path}.{os.getpid()}.tmp'
        fits.HDUList([fits.PrimaryHDU(data, header)]).writeto(tmp)
        os.replace(tmp, path)
    return path


def setup_kernels():
    import planetmapper_tpu

    planetmapper_tpu.set_kernel_path(KERNEL_PATH)


def assert_arrays_close(a, b, *, rtol=1e-5, atol=1e-8, equal_nan=False):
    a = np.asarray(a)
    b = np.asarray(b)
    if not np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan):
        diff = np.abs(a - b)
        aerr = np.nan if np.all(np.isnan(diff)) else np.nanmax(diff)
        raise AssertionError(f'Arrays not close (max abs err {aerr!r}):\n{a!r}\n{b!r}')
