"""Windowed nearest-waypoint search parity incl. truncation/tie edges (Q5)."""

import numpy as np
import jax.numpy as jnp

from mppi_robotarm.ops.waypoint import (
    nearest_in_window,
    slice_window,
    update_waypoint_index,
)
from oracle import OracleMPPI, oracle_fk


def _oracle_nearest(ref_path, prev_idx, q1, q2):
    o = OracleMPPI(ref_path)
    o.prev_idx = prev_idx
    return o.nearest(np.asarray(q1), np.asarray(q2))


def test_nearest_matches_oracle(ref_path, rng):
    for prev_idx in [0, 17, 500, 1500]:
        q1 = rng.uniform(-np.pi, np.pi, size=(64,))
        q2 = rng.uniform(-np.pi, np.pi, size=(64,))
        window, valid = slice_window(jnp.asarray(ref_path), prev_idx, 30)
        x, y = oracle_fk(q1, q2)
        off, rx, ry, rd1, rd2 = nearest_in_window(
            jnp.asarray(x), jnp.asarray(y), window, valid, 100.0)
        idx_exp, rx_e, ry_e, rd1_e, rd2_e = _oracle_nearest(
            ref_path, prev_idx, q1, q2)
        np.testing.assert_array_equal(np.asarray(off) + prev_idx, idx_exp)
        np.testing.assert_allclose(rx, rx_e, rtol=1e-12)
        np.testing.assert_allclose(rd2, rd2_e, rtol=1e-12)


def test_window_truncation_at_path_end(ref_path):
    """Near the path end the reference's Python slice truncates; our masked
    gather must scan exactly the same (shorter) candidate set."""
    n = ref_path.shape[0]
    for prev_idx in [n - 30, n - 5, n - 1]:
        # A state whose FK is closest to the LAST waypoint: any clamped
        # duplicate rows must not win over the true index.
        q1, q2 = 0.3, 0.4
        x, y = oracle_fk(np.float64(q1), np.float64(q2))
        window, valid = slice_window(jnp.asarray(ref_path), prev_idx, 30)
        assert int(np.asarray(valid).sum()) == min(30, n - prev_idx)
        off, *_ = nearest_in_window(jnp.asarray(x), jnp.asarray(y), window,
                                    valid, 100.0)
        idx_exp, *_ = _oracle_nearest(ref_path, prev_idx, q1, q2)
        assert int(off) + prev_idx == int(idx_exp)


def test_tie_breaks_to_first():
    """Duplicate-distance rows resolve to the lowest index, matching
    ``list.index(min(d))`` (control.py:215)."""
    path = np.zeros((10, 4))
    path[:, 0] = [1.0, 2.0, 2.0, 1.0, 5.0, 5.0, 5.0, 5.0, 5.0, 5.0]
    window, valid = slice_window(jnp.asarray(path), 0, 30)
    off, *_ = nearest_in_window(jnp.asarray(2.0), jnp.asarray(0.0), window,
                                valid, 100.0)
    assert int(off) == 1


def test_update_waypoint_index(ref_path, rng):
    """The once-per-solve frozen-index advance + re-slice (control.py:75, Q5)."""
    o = OracleMPPI(ref_path)
    o.prev_idx = 40
    q1, q2 = 1.1, -1.2
    idx_exp, *_ = o.nearest(q1, q2, update=True)
    x, y = oracle_fk(np.float64(q1), np.float64(q2))
    new_idx, window, valid = update_waypoint_index(
        jnp.asarray(ref_path), jnp.asarray(40), x, y, 30, 100.0)
    assert int(new_idx) == int(idx_exp) == o.prev_idx
    np.testing.assert_allclose(np.asarray(window)[0], ref_path[int(new_idx)],
                               rtol=1e-12)
