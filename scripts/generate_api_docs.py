#!/usr/bin/env python3
"""
Generate the markdown API reference under ``docs/api/``.

Autogenerated analogue of the reference's Sphinx autodoc site (the
reference builds its API pages with sphinx autodoc plus a generated
default-backplanes page, docs/make_default_backplanes_rst_page.py): every
public symbol is documented by introspection so the pages never need hand
maintenance, and the default-backplanes table is produced by registering
the real backplanes on a live ``BodyXY`` instance.

Usage::

    python scripts/generate_api_docs.py          # (re)write docs/api/
    python scripts/generate_api_docs.py --check  # fail if docs/api/ stale

``--check`` is run by ``tests/test_docs.py`` so CI catches drift between
the code and the committed pages.
"""

from __future__ import annotations

import inspect
import os
import shutil
import sys
import tempfile

os.environ['JAX_PLATFORMS'] = 'cpu'  # doc generation never needs a device

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

OUT_DIR_DEFAULT = os.path.join(REPO_ROOT, 'docs', 'api')

# Page spec: (filename, title, intro, [dotted targets]).
# A target resolving to a class renders the full class (public methods,
# properties, attributes); a module renders its docstring plus every
# public function/class defined in it.
PAGES: list[tuple[str, str, str, list[str]]] = [
    (
        'planetmapper_tpu.md',
        'planetmapper_tpu (package root)',
        'Top-level functions and constants re-exported at the package '
        'root. The main classes have their own pages (see the index).',
        ['planetmapper_tpu'],
    ),
    (
        'spicebase.md',
        'SpiceBase',
        'Runtime base class: kernel management hooks, time conversion, '
        'string/ID utilities shared by every body class.',
        ['planetmapper_tpu.base.SpiceBase'],
    ),
    (
        'body.md',
        'Body',
        'The core geometry engine: coordinate transforms, limb/terminator '
        'curves, rings, illumination and wireframe plotting.',
        [
            'planetmapper_tpu.body.Body',
            'planetmapper_tpu.body.AngularCoordinateKwargs',
            'planetmapper_tpu.body.WireframeKwargs',
            'planetmapper_tpu.body.WireframeComponent',
            'planetmapper_tpu.body.LonLatGridKwargs',
        ],
    ),
    (
        'basicbody.md',
        'BasicBody',
        'Minimal body for targets without radius/rotation data (e.g. '
        'minor satellites present only in an SPK segment).',
        ['planetmapper_tpu.basic_body.BasicBody'],
    ),
    (
        'bodyxy.md',
        'BodyXY',
        'Pixel/backplane engine: maps the geometry engine onto an image '
        'pixel grid set by disc parameters, generates backplanes and '
        'mapped projections on device.',
        [
            'planetmapper_tpu.body_xy.BodyXY',
            'planetmapper_tpu.body_xy.Backplane',
            'planetmapper_tpu.body_xy.BackplaneNotFoundError',
            'planetmapper_tpu.body_xy.MapKwargs',
        ],
    ),
    (
        'observation.md',
        'Observation',
        'Observation I/O: FITS/image loading, WCS-based disc '
        'initialisation, disc fitting and navigated-file export.',
        ['planetmapper_tpu.observation.Observation'],
    ),
    (
        'gui.md',
        'GUI',
        'Interactive tkinter/matplotlib user interface.',
        ['planetmapper_tpu.gui.GUI', 'planetmapper_tpu.gui.run_gui'],
    ),
    (
        'utils.md',
        'utils',
        '',
        ['planetmapper_tpu.utils', 'planetmapper_tpu.utils.DMSFormatter',
         'planetmapper_tpu.utils.DMSLocator'],
    ),
    (
        'progress.md',
        'progress',
        '',
        ['planetmapper_tpu.progress'],
    ),
    (
        'exceptions.md',
        'exceptions',
        '',
        ['planetmapper_tpu.exceptions'],
    ),
    (
        'kernel_downloader.md',
        'kernel_downloader',
        '',
        ['planetmapper_tpu.kernel_downloader'],
    ),
    (
        'data_loader.md',
        'data_loader',
        '',
        ['planetmapper_tpu.data_loader'],
    ),
    (
        'kernels.md',
        'kernels (SPICE kernel engine)',
        'Pure-Python/JAX SPICE kernel machinery: DAF reading, SPK '
        'segment evaluation, text kernels, the kernel pool and NAIF ID '
        'resolution.',
        [
            'planetmapper_tpu.kernels.pool',
            'planetmapper_tpu.kernels.daf',
            'planetmapper_tpu.kernels.spk',
            'planetmapper_tpu.kernels.sgp4',
            'planetmapper_tpu.kernels.textkernel',
            'planetmapper_tpu.kernels.naif_ids',
            'planetmapper_tpu.kernels.synthetic',
        ],
    ),
    (
        'core.md',
        'core (device geometry engine)',
        'The on-device ephemeris/frame/scene engine that replaces '
        'per-pixel CSPICE calls with batched JAX programs.',
        [
            'planetmapper_tpu.core.ephemeris',
            'planetmapper_tpu.core.frames',
            'planetmapper_tpu.core.inertial',
            'planetmapper_tpu.core.geometry',
            'planetmapper_tpu.core.scene',
            'planetmapper_tpu.core.time',
            'planetmapper_tpu.core.timebase',
        ],
    ),
    (
        'ops.md',
        'ops (numerical kernels)',
        'Device numerical building blocks: interpolation, projections, '
        'photometry and mixed-precision helpers.',
        [
            'planetmapper_tpu.ops.interp',
            'planetmapper_tpu.ops.interp_device',
            'planetmapper_tpu.ops.pchip_device',
            'planetmapper_tpu.ops.projections',
            'planetmapper_tpu.ops.photometry',
            'planetmapper_tpu.ops.fastmath',
        ],
    ),
    (
        'io.md',
        'io (FITS/WCS)',
        'Native FITS reading/writing and WCS solving (no astropy).',
        ['planetmapper_tpu.io.fits', 'planetmapper_tpu.io.wcs'],
    ),
    (
        'parallel.md',
        'parallel (multi-device scaling)',
        'Sharding, time-series batching, distributed disc fitting and '
        'multi-host initialisation over a ``jax.sharding.Mesh``.',
        [
            'planetmapper_tpu.parallel.sharding',
            'planetmapper_tpu.parallel.timeseries',
            'planetmapper_tpu.parallel.fit',
            'planetmapper_tpu.parallel.multihost',
        ],
    ),
    (
        'pipeline.md',
        'pipeline (fused backplane pipeline)',
        '',
        ['planetmapper_tpu.pipeline'],
    ),
    (
        'cli.md',
        'Command line interface',
        '',
        ['planetmapper_tpu.cli'],
    ),
]


def _doc(obj) -> str:
    doc = inspect.getdoc(obj)
    return doc.strip() if doc else ''


def _signature(obj, name: str) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        sig = '(...)'
    return f'{name}{sig}'


def _anchor(text: str) -> str:
    # GitHub-style heading slug: lowercase, spaces to hyphens, punctuation
    # (including backticks and dots) dropped, underscores/hyphens kept.
    out = []
    for ch in text.lower():
        if ch.isalnum() or ch in '_-':
            out.append(ch)
        elif ch == ' ':
            out.append('-')
    return ''.join(out)


def _member_sort_key(cls, name: str):
    # Definition order within the class body where discoverable, else
    # alphabetical at the end.
    member = cls.__dict__[name]
    func = member
    if isinstance(member, (classmethod, staticmethod)):
        func = member.__func__
    elif isinstance(member, property):
        func = member.fget
    try:
        _, lineno = inspect.getsourcelines(func)
        return (0, lineno)
    except (TypeError, OSError):
        return (1, name)


def render_class(cls, level: int = 2) -> list[str]:
    h = '#' * level
    lines = [f'{h} class `{cls.__name__}`', '']
    bases = [
        b for b in cls.__bases__ if b is not object and b.__name__ != 'Generic'
    ]
    if bases:
        base_names = ', '.join(f'`{b.__name__}`' for b in bases)
        lines.append(
            f'*Bases: {base_names}* — inherited members are documented on '
            'the base class page.'
        )
        lines.append('')
    try:
        init = cls.__dict__.get('__init__')
        if init is not None and not isinstance(cls, type(dict)) is False:
            pass
    except Exception:
        init = None
    if '__init__' in cls.__dict__ or issubclass(cls, tuple):
        lines.append('```python')
        lines.append(_signature(cls, cls.__name__))
        lines.append('```')
        lines.append('')
    doc = _doc(cls)
    if doc:
        lines.append(doc)
        lines.append('')

    # NamedTuple / TypedDict field tables
    annotations = cls.__dict__.get('__annotations__', {})
    if annotations and (
        issubclass(cls, tuple) or hasattr(cls, '__total__')
    ):
        lines.append('| Field | Type |')
        lines.append('|---|---|')
        for field, tp in annotations.items():
            tp_str = tp if isinstance(tp, str) else getattr(
                tp, '__name__', str(tp)
            )
            lines.append(f'| `{field}` | `{tp_str}` |')
        lines.append('')
        return lines

    names = [
        n
        for n in cls.__dict__
        if not n.startswith('_')
        and not isinstance(cls.__dict__[n], (int, float, str, dict, list,
                                             tuple, set, frozenset))
    ]
    names.sort(key=lambda n: _member_sort_key(cls, n))
    for name in names:
        member = cls.__dict__[name]
        is_prop = isinstance(member, property)
        func = member
        kind = ''
        if isinstance(member, classmethod):
            func = member.__func__
            kind = ' *(classmethod)*'
        elif isinstance(member, staticmethod):
            func = member.__func__
            kind = ' *(staticmethod)*'
        elif is_prop:
            func = member.fget
            kind = ' *(property)*'
        elif not callable(member):
            continue
        doc = _doc(func)
        if doc and ':meta private:' in doc:
            continue
        sub = '#' * (level + 1)
        lines.append(f'{sub} `{cls.__name__}.{name}`{kind}')
        lines.append('')
        if not is_prop:
            lines.append('```python')
            lines.append(_signature(func, name))
            lines.append('```')
            lines.append('')
        if doc:
            lines.append(doc)
            lines.append('')
    return lines


def render_module(mod, level: int = 2) -> list[str]:
    h = '#' * level
    lines = [f'{h} module `{mod.__name__}`', '']
    doc = _doc(mod)
    if doc:
        lines.append(doc)
        lines.append('')
    if mod.__name__ == 'planetmapper_tpu':
        # Root package: document __all__ resolved via lazy getattr, but
        # only functions/constants - classes/submodules have own pages.
        for name in mod.__all__:
            obj = getattr(mod, name)
            if inspect.ismodule(obj) or inspect.isclass(obj):
                continue
            sub = '#' * (level + 1)
            if callable(obj):
                lines.append(f'{sub} `{name}`')
                lines.append('')
                lines.append('```python')
                lines.append(_signature(obj, name))
                lines.append('```')
                lines.append('')
                doc = _doc(obj)
                if doc:
                    lines.append(doc)
                    lines.append('')
            else:
                lines.append(f'{sub} `{name}`')
                lines.append('')
                rep = repr(obj)
                if len(rep) > 200:
                    rep = rep[:200] + '…'
                lines.append(f'Constant: `{rep}`')
                lines.append('')
        return lines

    public = getattr(mod, '__all__', None)
    if public is None:
        public = [
            n
            for n, obj in vars(mod).items()
            if not n.startswith('_')
            and (inspect.isfunction(obj) or inspect.isclass(obj))
            and getattr(obj, '__module__', None) == mod.__name__
        ]

    def line_of(name):
        obj = getattr(mod, name)
        try:
            return (0, inspect.getsourcelines(obj)[1])
        except (TypeError, OSError):
            return (1, name)

    for name in sorted(public, key=line_of):
        obj = getattr(mod, name)
        doc = _doc(obj)
        if doc and ':meta private:' in doc:
            continue
        if inspect.isclass(obj):
            if getattr(obj, '__module__', None) != mod.__name__:
                continue
            lines.extend(render_class(obj, level=level + 1))
        elif callable(obj):
            sub = '#' * (level + 1)
            lines.append(f'{sub} `{name}`')
            lines.append('')
            lines.append('```python')
            lines.append(_signature(obj, name))
            lines.append('```')
            lines.append('')
            if doc:
                lines.append(doc)
                lines.append('')
        else:
            sub = '#' * (level + 1)
            lines.append(f'{sub} `{name}`')
            lines.append('')
            rep = repr(obj)
            if len(rep) > 200:
                rep = rep[:200] + '…'
            lines.append(f'Constant: `{rep}`')
            lines.append('')
    return lines


def render_backplanes_page() -> str:
    """
    Generated default-backplanes page (parity with the reference's
    docs/make_default_backplanes_rst_page.py generated table).
    """
    import planetmapper_tpu
    from planetmapper_tpu import BodyXY
    from planetmapper_tpu.kernels.synthetic import ensure_kernel_set

    # the page lists names only, so the seeded kernel set is enough
    if not os.environ.get('PLANETMAPPER_KERNEL_PATH'):
        planetmapper_tpu.set_kernel_path(ensure_kernel_set())
    body = BodyXY('Jupiter', observer='EARTH', utc='2005-01-01T00:00:00')
    lines = [
        '# Default backplanes',
        '',
        '*This page is generated by `scripts/generate_api_docs.py` from '
        'the live backplane registry of a `BodyXY` instance — do not edit '
        'by hand.*',
        '',
        'Every `BodyXY` (and therefore every `Observation`) registers '
        'these backplanes on construction. Each can be computed for the '
        'image pixel grid (`get_backplane_img`) or for a map projection '
        '(`get_backplane_map`), and all are written as FITS extensions by '
        '`Observation.save_observation` / `save_mapped_observation`. '
        'Longitude direction in descriptions follows each body\'s IAU '
        'convention (the table below was generated for Jupiter, which is '
        'positive-west).',
        '',
        '| Name | Description | Image getter | Map getter |',
        '|---|---|---|---|',
    ]
    for bp in body.backplanes.values():
        img = bp.get_img.__name__
        mp = bp.get_map.__name__
        lines.append(
            f'| `{bp.name}` | {bp.description} | '
            f'[`BodyXY.{img}`](bodyxy.md#{_anchor("BodyXY." + img)}) | '
            f'[`BodyXY.{mp}`](bodyxy.md#{_anchor("BodyXY." + mp)}) |'
        )
    lines.append('')
    lines.append(
        'Additional backplanes can be added with '
        '`BodyXY.register_backplane`, and ring-plane backplanes follow '
        'the `RING-*` naming used above.'
    )
    lines.append('')
    return '\n'.join(lines)


def resolve(dotted: str):
    import importlib

    parts = dotted.split('.')
    for split in range(len(parts), 0, -1):
        try:
            mod = importlib.import_module('.'.join(parts[:split]))
        except ImportError:
            continue
        obj = mod
        for attr in parts[split:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(dotted)


def generate(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    index_lines = [
        '# API reference',
        '',
        '*Generated by `scripts/generate_api_docs.py` — do not edit by '
        'hand. Regenerate with* `python scripts/generate_api_docs.py`.',
        '',
        '| Page | Contents |',
        '|---|---|',
        '| [Default backplanes](backplanes_default.md) | Generated table '
        'of every default backplane |',
    ]
    for filename, title, intro, targets in PAGES:
        body_lines = [f'# {title}', '']
        body_lines.append(
            '*Generated by `scripts/generate_api_docs.py` — do not edit '
            'by hand.*'
        )
        body_lines.append('')
        if intro:
            body_lines.append(intro)
            body_lines.append('')
        for dotted in targets:
            obj = resolve(dotted)
            if inspect.ismodule(obj):
                body_lines.extend(render_module(obj))
            elif inspect.isclass(obj):
                body_lines.extend(render_class(obj))
            else:
                body_lines.append(f'## `{dotted.rsplit(".", 1)[1]}`')
                body_lines.append('')
                body_lines.append('```python')
                body_lines.append(
                    _signature(obj, dotted.rsplit('.', 1)[1])
                )
                body_lines.append('```')
                body_lines.append('')
                doc = _doc(obj)
                if doc:
                    body_lines.append(doc)
                    body_lines.append('')
        with open(os.path.join(out_dir, filename), 'w') as f:
            f.write('\n'.join(body_lines).rstrip() + '\n')
        index_lines.append(f'| [{title}]({filename}) | {intro or title} |')

    with open(os.path.join(out_dir, 'backplanes_default.md'), 'w') as f:
        f.write(render_backplanes_page())
    with open(os.path.join(out_dir, 'index.md'), 'w') as f:
        f.write('\n'.join(index_lines).rstrip() + '\n')

    _check_coverage(out_dir)


def _check_coverage(out_dir: str) -> None:
    """Every root public symbol must appear in some generated page."""
    import planetmapper_tpu

    corpus = ''
    for name in os.listdir(out_dir):
        with open(os.path.join(out_dir, name)) as f:
            corpus += f.read()
    missing = [
        name
        for name in planetmapper_tpu.__all__
        # Submodules in __all__ (base, gui, ...) are covered by their own
        # pages under their class/function names.
        if not inspect.ismodule(getattr(planetmapper_tpu, name))
        and f'`{name}`' not in corpus
        and f'.{name}`' not in corpus
    ]
    if missing:
        raise SystemExit(
            f'generated docs do not cover public symbols: {missing}'
        )


def main() -> None:
    if '--check' in sys.argv:
        tmp = tempfile.mkdtemp(prefix='apidocs_')
        try:
            generate(tmp)
            import filecmp

            expected = sorted(os.listdir(tmp))
            actual = sorted(
                n for n in os.listdir(OUT_DIR_DEFAULT)
                if not n.startswith('.')
            ) if os.path.isdir(OUT_DIR_DEFAULT) else []
            if expected != actual:
                raise SystemExit(
                    f'docs/api file set stale: generated {expected}, '
                    f'committed {actual}'
                )
            stale = [
                n for n in expected
                if not filecmp.cmp(
                    os.path.join(tmp, n),
                    os.path.join(OUT_DIR_DEFAULT, n),
                    shallow=False,
                )
            ]
            if stale:
                raise SystemExit(
                    f'docs/api stale (regenerate with '
                    f'scripts/generate_api_docs.py): {stale}'
                )
            print('docs/api up to date')
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    else:
        generate(OUT_DIR_DEFAULT)
        n = len(os.listdir(OUT_DIR_DEFAULT))
        print(f'wrote {n} pages to {OUT_DIR_DEFAULT}')


if __name__ == '__main__':
    main()
