"""Package metadata (reference parity: planetmapper/common.py)."""

__version__ = '0.1.0'
__author__ = 'planetmapper-tpu developers'
__url__ = 'https://github.com/planetmapper-tpu/planetmapper-tpu'
__license__ = 'MIT'
__description__ = (
    'JAX planetary geometry, navigation and mapping framework'
)

CITATION_STRING = (
    'planetmapper_tpu: a JAX planetary geometry framework, '
    f'version {__version__}'
)
CITATION_DOI = ''
CITATION_BIBTEX = (
    '@misc{planetmapper_tpu,\n'
    '  title = {planetmapper\\_tpu: a JAX planetary geometry framework},\n'
    f'  note = {{version {__version__}}},\n'
    '}'
)
