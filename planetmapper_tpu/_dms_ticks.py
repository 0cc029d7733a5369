"""
Degree-minute-second tick locator and formatter for matplotlib axes,
exported as :class:`planetmapper_tpu.utils.DMSFormatter` and
:class:`planetmapper_tpu.utils.DMSLocator`. Kept apart from
:mod:`.utils` so that importing the package does not import matplotlib.
"""

from __future__ import annotations

import numpy as np

try:
    import matplotlib.ticker
except ImportError as exc:  # pragma: no cover - exercised without mpl
    raise ImportError(
        'planetmapper_tpu needs matplotlib for plotting and RA/Dec axis '
        'formatting; install matplotlib to use them'
    ) from exc

from .utils import _SexagesimalScale


class DMSFormatter(matplotlib.ticker.Formatter):
    """
    Tick formatter displaying angles as degrees/minutes/seconds
    (e.g. 12°34′56″); pairs with :class:`DMSLocator`. Constant leading
    fields are moved into the axis offset string.
    """

    def __init__(self) -> None:
        super().__init__()
        self._scale: _SexagesimalScale | None = None
        self._offset_text = ''

    def _get_scale(self) -> _SexagesimalScale:
        if self._scale is None:
            vmin, vmax = self.axis.get_view_interval()
            self._scale = _SexagesimalScale(vmin, vmax)
        return self._scale

    def __call__(self, x, pos=None) -> str:
        return self._get_scale().label(x)

    def set_locs(self, locs) -> None:
        """:meta private:"""
        vmin, vmax = self.axis.get_view_interval()
        self._scale = _SexagesimalScale(vmin, vmax)
        self._offset_text = self._scale.offset_string()
        super().set_locs(locs)

    def get_offset(self) -> str:
        """:meta private:"""
        return self._offset_text


class DMSLocator(matplotlib.ticker.Locator):
    """
    Tick locator snapping ticks to whole numbers of the sexagesimal field
    chosen by :class:`_SexagesimalScale`; pairs with :class:`DMSFormatter`.
    """

    def __init__(self) -> None:
        super().__init__()
        self._nice = matplotlib.ticker.MaxNLocator(
            steps=[1, 2, 5, 10], nbins=8
        )

    def __call__(self):
        vmin, vmax = self.axis.get_view_interval()
        return self.tick_values(vmin, vmax)

    def tick_values(self, vmin: float, vmax: float) -> np.ndarray:
        """:meta private:"""
        scale = _SexagesimalScale(vmin, vmax)
        unit = scale.unit_size
        ticks = self._nice.tick_values(vmin / unit, vmax / unit)
        return np.asarray(ticks) * unit
