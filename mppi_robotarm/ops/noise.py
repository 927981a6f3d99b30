"""On-device MPPI exploration-noise generation.

The reference samples on the host with the *unseeded global* NumPy RNG:
``np.random.multivariate_normal(0, Σ, (K, T))`` (control.py:154-164, quirk
Q8) — runs are non-reproducible.  Here noise is generated on device from
explicit threefry keys (split per solve step), as ``N(0, I) @ chol(Σ)ᵀ``.

Golden-parity seam (SURVEY.md §7 hard part (c)): every solver entry point
also accepts an externally-supplied ``eps`` array so tests can feed the
identical noise to both the solver and the NumPy oracle.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def sigma_cholesky(sigma) -> np.ndarray:
    """Lower-triangular Cholesky factor of the (2,2) noise covariance.

    Computed on the host at trace time (sigma is config data, not traced).
    """
    return np.linalg.cholesky(np.asarray(sigma, dtype=np.float64))


def sigma_inverse(sigma) -> np.ndarray:
    """Σ⁻¹ for the control-affine cost term γ·uᵀΣ⁻¹v (control.py:106)."""
    return np.linalg.inv(np.asarray(sigma, dtype=np.float64))


def sample_epsilon(key, num_samples: int, horizon: int, chol: jnp.ndarray,
                   dtype=jnp.float32) -> jnp.ndarray:
    """Draw ε ~ N(0, Σ) of shape (K, T, 2) on device.

    Equivalent in distribution to control.py:163 (which uses an SVD
    factorisation on the host); the factorisation choice is free because
    parity tests inject ε explicitly.
    """
    z = jax.random.normal(key, (num_samples, horizon, 2), dtype=dtype)
    # ε_i = Σ_j z_j·L_ij as multiply-and-sum, not a matmul: exact float32
    # (a GPU may run a float32 matmul in TF32), and elementwise, so it fuses
    # with the generator instead of launching a K·T×2×2 GEMM
    return (z[..., None, :] * jnp.asarray(chol, dtype=dtype)).sum(axis=-1)
