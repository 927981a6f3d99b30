"""Debug / sanitizer modes (SURVEY.md §5.2).

The reference is single-threaded NumPy with two ad-hoc guards (Σ shape check,
path-end IndexError).  The analogues provided here:

  * :func:`debug_mode` — context enabling ``jax_debug_nans`` +
    ``jax_enable_checks`` (NaN propagation and internal invariant checks);
  * :func:`checked_solve` — a ``checkify``-wrapped solve that turns the
    path-end condition (quirk Q6) and any NaN in the returned control into
    functional, jit-safe errors carried out of the computation.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from ..config import ArmParams, MPPIConfig
from ..mppi.solver import MPPIState, solve


@contextlib.contextmanager
def debug_mode(nans: bool = True, checks: bool = True):
    """Enable jax_debug_nans / jax_enable_checks within the block."""
    old_nans = jax.config.jax_debug_nans
    old_checks = jax.config.jax_enable_checks
    try:
        jax.config.update("jax_debug_nans", nans)
        jax.config.update("jax_enable_checks", checks)
        yield
    finally:
        jax.config.update("jax_debug_nans", old_nans)
        jax.config.update("jax_enable_checks", old_checks)


def checked_solve(arm: ArmParams, cfg: MPPIConfig, ref_path, observed_x,
                  state: MPPIState, **kw):
    """Checkified solve: returns (error, SolveResult).

    ``error.throw()`` raises on (a) reaching the reference's IndexError
    condition (control.py:76-78) or (b) non-finite controls — instead of
    silently propagating a frozen/poisoned state through a scan.
    """
    def _inner(ref_path, observed_x, state):
        res = solve(arm, cfg, ref_path, observed_x, state, **kw)
        checkify.check(jnp.logical_not(res.path_end),
                       "Reached the end of the reference path.")
        checkify.check(jnp.all(jnp.isfinite(res.u0)),
                       "non-finite control output")
        return res

    checked = checkify.checkify(_inner)
    return checked(ref_path, observed_x, state)
