"""matplotlib's 'jet' colour map in numpy, value for value: its 256-entry
table built from the map's segment data as ``LinearSegmentedColormap``
builds it, and a float in [0, 1] looked up as ``Colormap.__call__`` does
(x * 256 truncated, 1.0 to the last entry). Depth and error images are
coloured with it without matplotlib."""

from __future__ import annotations

import numpy as np

_N = 256
_JET = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}


def _channel(data) -> np.ndarray:
    a = np.asarray(data, np.float64)
    x, y0, y1 = a[:, 0] * (_N - 1), a[:, 1], a[:, 2]
    xind = (_N - 1) * np.linspace(0, 1, _N)
    ind = np.searchsorted(x, xind)[1:-1]
    dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], dist * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


_LUT = np.stack([_channel(_JET[c]) for c in ("red", "green", "blue")], axis=-1)


def jet_uint8(x: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 colours of values in [0, 1]; NaN maps to black, as
    matplotlib's 'bad' colour (transparent black) does."""
    xa = np.array(x, np.float64) * _N
    bad = np.isnan(xa)
    xa[xa == _N] = _N - 1
    with np.errstate(invalid="ignore"):
        idx = np.clip(np.where(bad, 0, xa), 0, _N - 1).astype(np.int64)
    rgb = _LUT[idx]
    rgb[bad] = 0.0
    return (rgb * 255).astype(np.uint8)
