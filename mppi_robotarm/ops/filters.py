"""Control-sequence smoothing filters.

The reference smooths the weighted-noise update with
``scipy.ndimage.median_filter(size=10, mode='reflect')`` applied per control
dimension over the horizon axis (control.py:122, 319-327 — quirk Q10).  A
moving-average variant exists but is dead code (control.py:329-344, C18); we
provide both, with the median filter matching scipy bit-for-bit.

scipy semantics being replicated (validated by tests/test_filters.py):
  * ``median_filter(size=s)`` == ``rank_filter(rank=s//2, size=s)`` with
    origin 0: the window for output index ``i`` spans offsets
    ``[-(s//2), s - s//2 - 1]`` (for s=10: i-5 .. i+4).
  * mode='reflect' duplicates the edge sample — numpy/jnp pad mode
    'symmetric', NOT numpy's 'reflect'.
  * even window: rank s//2 selects the (s//2)-th order statistic (0-indexed),
    i.e. the upper middle element — no averaging of the two middles.

Device mapping: the horizon is tiny (T=30-50), so the filter is a static stack
of shifted slices + one ``jnp.sort`` over the window axis — negligible cost,
fully fusable, no dynamic shapes.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp


def median_filter_reflect(x: jnp.ndarray, size: int) -> jnp.ndarray:
    """Moving median over axis 0 of ``x`` (shape (T, D)), scipy-parity.

    Equivalent to ``scipy.ndimage.median_filter(x[:, d], size, mode='reflect')``
    per column d (reference control.py:319-327).
    """
    if size < 1:
        raise ValueError("size must be >= 1")
    if size == 1:
        return x
    t = x.shape[0]
    left = size // 2
    rank = size // 2
    # scipy 'reflect' extends by edge-inclusive reflection with period 2t:
    # ... d c b a | a b c d | d c b a ...  The index map is computed
    # explicitly (instead of jnp.pad 'symmetric').  Parity domain: size <=
    # 2t, which covers the reference (size=10, T>=30, control.py:122) with a
    # wide margin — beyond one full fold scipy's C buffer code injects
    # cval=0.0 instead of continuing the reflection (observed scipy 1.17
    # behaviour); we continue the periodic reflection, which is the
    # mathematically consistent extension.
    idx = np.arange(-left, t - left + size - 1)
    period = 2 * t
    j = np.mod(idx, period)
    j = np.where(j < t, j, period - 1 - j)
    xp = x[jnp.asarray(j)]
    windows = jnp.stack([xp[k : k + t] for k in range(size)], axis=0)
    return jnp.sort(windows, axis=0)[rank]


def moving_average_filter(x: jnp.ndarray, window_size: int) -> jnp.ndarray:
    """Edge-corrected moving average (reference control.py:329-344, dead code C18).

    Re-implemented for completeness: 'same'-mode convolution with a uniform
    kernel, with the reference's edge renormalisation factors applied to the
    first/last ``ceil(w/2)`` samples.
    """
    t, d = x.shape
    b = jnp.ones((window_size,)) / window_size
    cols = []
    for j in range(d):
        cols.append(jnp.convolve(x[:, j], b, mode="same"))
    out = jnp.stack(cols, axis=1)
    n_conv = math.ceil(window_size / 2)
    # Edge correction factors (control.py:340-343).
    scale = jnp.ones((t,))
    scale = scale.at[0].set(window_size / n_conv)
    for i in range(1, n_conv):
        scale = scale.at[i].set(window_size / (i + n_conv))
        scale = scale.at[t - i].set(
            window_size / (i + n_conv - (window_size % 2))
        )
    return out * scale[:, None]
