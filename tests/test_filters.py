"""Median/moving-average filter parity vs scipy and the reference formula."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.ndimage import median_filter

from mppi_robotarm.ops.filters import (
    median_filter_reflect,
    moving_average_filter,
)


@pytest.mark.parametrize("t", [5, 10, 30, 50])
@pytest.mark.parametrize("size", [1, 2, 3, 4, 5, 9, 10, 11, 12])
def test_median_matches_scipy(t, size, rng):
    if size > 2 * t:
        pytest.skip("beyond one reflection fold scipy injects cval=0 "
                    "(scipy buffer quirk); out of the parity domain")
    x = rng.normal(size=(t, 2))
    got = np.asarray(median_filter_reflect(jnp.asarray(x), size))
    exp = np.stack(
        [median_filter(x[:, d], size=size, mode="reflect") for d in range(2)],
        axis=1,
    )
    np.testing.assert_array_equal(got, exp)


def test_median_reference_config(rng):
    """The exact reference call: T=30, size=10, mode='reflect' (control.py:122)."""
    x = rng.normal(size=(30, 2)) * 5.0
    got = np.asarray(median_filter_reflect(jnp.asarray(x), 10))
    exp = np.stack(
        [median_filter(x[:, d], size=10, mode="reflect") for d in range(2)],
        axis=1,
    )
    np.testing.assert_array_equal(got, exp)


def _reference_moving_average(xx, window_size):
    """The reference's edge-corrected MA (control.py:329-344), re-derived."""
    b = np.ones(window_size) / window_size
    out = np.stack([np.convolve(xx[:, d], b, mode="same") for d in range(2)],
                   axis=1)
    n_conv = math.ceil(window_size / 2)
    out[0] *= window_size / n_conv
    for i in range(1, n_conv):
        out[i] *= window_size / (i + n_conv)
        out[-i] *= window_size / (i + n_conv - (window_size % 2))
    return out


@pytest.mark.parametrize("size", [3, 5, 10])
def test_moving_average_matches_reference(size, rng):
    x = rng.normal(size=(30, 2))
    got = np.asarray(moving_average_filter(jnp.asarray(x), size))
    exp = _reference_moving_average(x, size)
    np.testing.assert_allclose(got, exp, rtol=1e-12, atol=1e-12)
