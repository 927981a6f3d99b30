"""Functional single-chip MPPI solver.

The reference's ``MPPIControllerForPathTracking.calc_control_input``
(control.py:67-152) is a stateful method mutating ``self.u_prev`` and
``self.prev_waypoints_idx``.  Here the solve is a pure function over an
explicit :class:`MPPIState`, making quirk Q3 (the in-place aliasing of
``u_prev``) explicit: the net reference semantics are

    u_new        = u_prev + median_filter(Σₖ wₖ εₖ)
    u_prev_next  = shift_left(u_new) with the last row duplicated
    return       u_prev_next[0]   (= u_new[1] for T ≥ 2)

Note the LAST line: because ``u`` aliases ``self.u_prev``, the in-place
warm-start shift (control.py:148-149) happens BEFORE ``return u[0]``
(control.py:152), so the control the reference actually applies to the
plant each step is the SHIFTED first element — ``u_new[1]``, not
``u_new[0]``.  Verified empirically against the executed reference
(tools/make_reference_golden.py; tests/test_golden_reference.py pins the
multi-step closed loop).  ``SolveResult.u_seq`` stays ``u_new`` because the
viz re-rollouts (control.py:129-145) run before the shift.

and the waypoint index advances once per solve from the observed state (Q5).
The path-end condition (reference raises ``IndexError``, control.py:76-78,
quirk Q6) is returned as a ``path_end`` flag — the Python driver raises, the
scan-compiled simulator carries it as a freeze flag.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..config import ArmParams, MPPIConfig
from ..models.arm import fk_ee
from ..ops.filters import median_filter_reflect
from ..ops.noise import sample_epsilon, sigma_cholesky, sigma_inverse
from ..ops.pallas_rollout import rollout_costs_pallas
from ..ops.rollout import rollout_costs, rollout_trajectory
from ..ops.waypoint import update_waypoint_index
from ..ops.weights import mppi_weights


class MPPIState(NamedTuple):
    """Per-scenario solver state threaded through the receding-horizon loop."""

    u_prev: jnp.ndarray          # (T, 2) warm-started control sequence
    wp_idx: jnp.ndarray          # () int32 frozen waypoint index


class SolveResult(NamedTuple):
    u0: jnp.ndarray              # (2,) control to apply now — the SHIFTED
                                 # first element, = state.u_prev[0] = u_seq[1]
                                 # for T >= 2 (reference control.py:148-152)
    u_seq: jnp.ndarray           # (T, 2) updated pre-shift sequence u_new
    state: MPPIState             # next solver state (shifted warm start, new idx)
    path_end: jnp.ndarray        # () bool — reference IndexError condition (Q6)
    costs: jnp.ndarray           # (K,) per-sample total costs S
    weights: jnp.ndarray         # (K,) importance weights w
    eps: jnp.ndarray             # (K, T, 2) the noise actually used


class VizResult(NamedTuple):
    """Optional visualisation re-rollouts (control.py:129-145, quirk Q4)."""

    optimal_traj: jnp.ndarray    # (T, 4)
    sampled_trajs: jnp.ndarray   # (K, T, 4)
    sorted_idx: jnp.ndarray      # (K,) argsort(S) — render order (run.py:88-90)


def init_state(cfg: MPPIConfig, dtype=jnp.float32) -> MPPIState:
    """Warm start ``u_prev = [(10, -2)] * T`` (control.py:59), index 0."""
    u0 = jnp.tile(jnp.asarray(cfg.warm_start, dtype=dtype), (cfg.horizon, 1))
    return MPPIState(u_prev=u0, wp_idx=jnp.asarray(0, jnp.int32))


def shift_warm_start(u_seq: jnp.ndarray) -> jnp.ndarray:
    """Warm-start shift: drop u[0], duplicate the last row (control.py:148-149)."""
    return jnp.concatenate([u_seq[1:], u_seq[-1:]], axis=0)


@partial(jax.jit, static_argnames=("arm", "cfg", "backend"))
def solve(
    arm: ArmParams,
    cfg: MPPIConfig,
    ref_path: jnp.ndarray,       # (N, 4) [x, y, dq1, dq2]
    observed_x: jnp.ndarray,     # (4,) [q1, q2, dq1, dq2]
    state: MPPIState,
    key: Optional[jax.Array] = None,
    eps: Optional[jnp.ndarray] = None,
    backend: str = "xla",
) -> SolveResult:
    """One MPPI solve — ``calc_control_input`` (control.py:67-152) as a pure
    function.

    Noise comes either from an on-device PRNG ``key`` or an injected ``eps``
    (the golden-parity seam — tests feed the identical noise to the NumPy
    oracle).  Exactly one of the two must be provided.

    ``backend``: 'xla' (``lax.scan`` rollout, any dtype) or 'pallas' (the
    rollout and its costs in one GPU kernel, float32 —
    ops/pallas_rollout.py).  Both draw the same noise for one key.
    """
    if (key is None) == (eps is None):
        raise ValueError("provide exactly one of key= or eps=")
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    cfg.validate()
    dtype = state.u_prev.dtype

    # Advance the frozen waypoint index from the observed state (Q5), then
    # re-slice the window at the new index for all K×T lookups.
    x_obs, y_obs = fk_ee(observed_x[0], observed_x[1], cfg.l1, cfg.l2)
    wp_idx, window, valid = update_waypoint_index(
        ref_path, state.wp_idx, x_obs, y_obs, cfg.search_idx_len,
        cfg.dist_scale,
    )
    path_end = wp_idx >= ref_path.shape[0] - 1      # control.py:76-78 (Q6)

    if eps is None:
        chol = sigma_cholesky(cfg.sigma)
        eps = sample_epsilon(key, cfg.num_samples, cfg.horizon, chol, dtype)
    eps = eps.astype(dtype)
    sigma_inv = jnp.asarray(sigma_inverse(cfg.sigma), dtype=dtype)
    if backend == "pallas":
        s = rollout_costs_pallas(arm, cfg, observed_x, state.u_prev, eps,
                                 window, valid, sigma_inv).astype(dtype)
    else:
        s, _ = rollout_costs(arm, cfg, observed_x, state.u_prev, eps,
                             window, valid, sigma_inv)
    w = mppi_weights(s, cfg.lam)
    # control.py:115-118; HIGHEST keeps a float32 contraction out of TF32
    w_eps_raw = jnp.einsum("k,ktu->tu", w, eps,
                           precision=lax.Precision.HIGHEST)

    w_eps = median_filter_reflect(w_eps_raw, cfg.filter_window)  # Q10
    u_seq = state.u_prev + w_eps                     # control.py:126 (Q3)

    next_state = MPPIState(u_prev=shift_warm_start(u_seq), wp_idx=wp_idx)
    return SolveResult(
        u0=next_state.u_prev[0], u_seq=u_seq, state=next_state,
        path_end=path_end, costs=s, weights=w, eps=eps,
    )


@partial(jax.jit, static_argnames=("arm", "cfg"))
def viz_rollouts(
    arm: ArmParams,
    cfg: MPPIConfig,
    observed_x: jnp.ndarray,
    u_seq: jnp.ndarray,          # (T, 2) post-update sequence
    u_prev: jnp.ndarray,         # (T, 2) pre-update sequence (for v)
    eps: jnp.ndarray,            # (K, T, 2)
    costs: jnp.ndarray,          # (K,)
) -> VizResult:
    """Optimal + sampled trajectory re-rollouts for rendering.

    Reproduces control.py:129-145 including quirk Q4 (controls applied rolled
    by one, last-first).  ``v`` is reconstructed from u_prev/eps exactly as in
    the cost rollout (control.py:98-101).
    """
    k_idx = jnp.arange(cfg.num_samples)
    exploit = (k_idx < (1.0 - cfg.exploration) * cfg.num_samples)[:, None, None]
    v = jnp.where(exploit, u_prev[None] + eps, eps)
    optimal_traj = rollout_trajectory(arm, cfg, observed_x, u_seq)
    sampled = rollout_trajectory(arm, cfg, observed_x, v)
    return VizResult(optimal_traj=optimal_traj, sampled_trajs=sampled,
                     sorted_idx=jnp.argsort(costs))
