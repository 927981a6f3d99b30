"""Windowed nearest-waypoint search (reference control.py:200-232).

The reference scans a 30-waypoint window ``ref_path[prev_idx : prev_idx+30]``
(SEARCH_IDX_LEN, control.py:203) from the *frozen* index (quirk Q5: the index
is advanced once per solve from the observed state; all K×T rollout lookups
then reuse the frozen window).  At the path end the Python slice truncates, so
fewer candidates are scanned; argmin ties resolve to the first index
(``list.index(min)``, control.py:215).

Device mapping (two pieces):
  * :func:`slice_window` — ONE clamped gather of the (W, 4) window per solve,
    plus a validity mask for truncated tails.  O(W) regardless of path length
    (SURVEY.md §5.7: long paths are free).
  * :func:`nearest_in_window` — fully batched distance + masked argmin against
    the pre-sliced window; runs inside the rollout at (K,) batch per step with
    only elementwise ops and a W-length reduction (W=30).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def slice_window(ref_path: jnp.ndarray, start_idx, window_len: int
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Gather ``ref_path[start_idx : start_idx+window_len]`` with truncation mask.

    Returns (window (W, C), valid (W,) bool).  Rows past the end of the path
    are clamped to the last row and masked invalid — exactly reproducing the
    reference's truncating Python slice (control.py:208-209) under jit, where
    ``start_idx`` is a traced scalar.
    """
    n = ref_path.shape[0]
    offs = jnp.arange(window_len)
    idx = start_idx + offs
    valid = idx < n
    window = jnp.take(ref_path, jnp.minimum(idx, n - 1), axis=0)
    return window, valid


def nearest_in_window(
    x: jnp.ndarray,
    y: jnp.ndarray,
    window: jnp.ndarray,
    valid: jnp.ndarray,
    dist_scale: float,
):
    """Masked nearest-waypoint lookup against a pre-sliced window.

    ``x``/``y``: task-space position, any batch shape (...,).
    ``window``: (W, >=4) rows [ref_x, ref_y, ref_dq1, ref_dq2, ...].
    ``valid``: (W,) mask from :func:`slice_window`.

    Returns (offset (...,) int32 — index *within* the window, ref_x, ref_y,
    ref_dq1, ref_dq2).  Distance metric is the reference's scaled squared
    distance ``(dx² + dy²)·100`` (control.py:212) — the scale does not affect
    the argmin but is kept for golden-value comparability.  Ties resolve to
    the lowest offset, matching ``list.index(min(d))`` (control.py:215).
    """
    dx = x[..., None] - window[:, 0]
    dy = y[..., None] - window[:, 1]
    d = (dx * dx + dy * dy) * dist_scale
    d = jnp.where(valid, d, jnp.inf)
    off = jnp.argmin(d, axis=-1)
    ref = jnp.take(window, off, axis=0)  # (..., C)
    return off, ref[..., 0], ref[..., 1], ref[..., 2], ref[..., 3]


def update_waypoint_index(
    ref_path: jnp.ndarray,
    wp_idx,
    x,
    y,
    window_len: int,
    dist_scale: float,
):
    """Once-per-solve frozen-index advance (control.py:75, update_prev_idx=True).

    Returns (new_idx, window, valid) so the solve can reuse the freshly-sliced
    window for all K×T stage-cost lookups (quirk Q5).  ``path_end`` — the
    reference's IndexError condition ``new_idx >= len(ref_path) - 1``
    (control.py:76-78) — is left to the caller to check.

    Note the window used for the rollouts is re-sliced at the *new* index:
    the reference advances ``prev_waypoints_idx`` first (control.py:75) and
    every subsequent `_c`/`_phi` lookup reads the updated index.
    """
    window0, valid0 = slice_window(ref_path, wp_idx, window_len)
    off, *_ = nearest_in_window(jnp.asarray(x), jnp.asarray(y), window0, valid0,
                                dist_scale)
    new_idx = (wp_idx + off).astype(jnp.int32)
    window, valid = slice_window(ref_path, new_idx, window_len)
    return new_idx, window, valid
