"""Batched K×T MPPI rollout + cost evaluation (the hot path).

Replaces the reference's Python triple loop (control.py:91-109: K samples ×
T steps × per-step 2x2 ``np.linalg.inv`` and Python waypoint search) with a
single ``lax.scan`` over the horizon whose body is fully batched over K —
pure elementwise work (analytic 2x2 inverse, fused trig) plus a W=30
masked argmin per step.  XLA fuses each scan iteration into a handful of
kernels; the Pallas path (ops/pallas_rollout.py) runs the entire scan in
one GPU kernel.

Semantics replicated exactly (SURVEY.md §3.2):
  * exploration split (Q9): samples k < (1-exploration)·K get u+ε, the rest
    pure ε (control.py:98-101);
  * stage cost on the *post-step* state + γ·uᵀΣ⁻¹v per step (control.py:104-106);
  * frozen-window waypoint lookup (Q5) against the pre-sliced window;
  * terminal cost φ on the final state (control.py:109);
  * cost ×10000 and distance ×100 scaling (Q7).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import ArmParams, MPPIConfig
from ..models.arm import arm_step, fk_ee
from .waypoint import nearest_in_window


def _stage_cost(q1, q2, dq1, dq2, window, valid, weights, cfg: MPPIConfig):
    """Weighted tracking cost of a batch of states vs their nearest waypoints.

    Reference `_c` / `_phi` (control.py:174-198): FK to task space, nearest
    waypoint in the frozen window, then
    w0·(x-rx)² + w1·(y-ry)² + w2·(dq1-rdq1)² + w3·(dq2-rdq2)², ×cost_scale.
    """
    x, y = fk_ee(q1, q2, cfg.l1, cfg.l2)
    _, rx, ry, rdq1, rdq2 = nearest_in_window(x, y, window, valid,
                                              cfg.dist_scale)
    c = (
        weights[0] * (x - rx) ** 2
        + weights[1] * (y - ry) ** 2
        + weights[2] * (dq1 - rdq1) ** 2
        + weights[3] * (dq2 - rdq2) ** 2
    )
    return c * cfg.cost_scale


def rollout_costs(
    arm: ArmParams,
    cfg: MPPIConfig,
    x0: jnp.ndarray,          # (4,) observed state [q1, q2, dq1, dq2]
    u: jnp.ndarray,           # (T, 2) nominal control sequence
    eps: jnp.ndarray,         # (K_local, T, 2) exploration noise
    window: jnp.ndarray,      # (W, 4) frozen waypoint window
    valid: jnp.ndarray,       # (W,) window validity mask
    sigma_inv: jnp.ndarray,   # (2, 2)
    k_offset=0,               # global index of this shard's first sample
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Evaluate the total cost S of K noisy rollouts.

    Returns (S (K,), x_final (K, 4)).  ``k_offset`` makes the exploration
    split (which depends on the *global* sample index, control.py:98) correct
    when the K axis is sharded across devices.
    """
    kloc = eps.shape[0]
    dtype = eps.dtype
    stage_w = jnp.asarray(cfg.stage_cost_weight, dtype=dtype)
    term_w = jnp.asarray(cfg.terminal_cost_weight, dtype=dtype)
    sigma_inv = jnp.asarray(sigma_inv, dtype=dtype)
    gamma = jnp.asarray(cfg.gamma, dtype=dtype)

    # Exploitation mask over global sample indices (Q9).
    k_global = k_offset + jnp.arange(kloc)
    exploit = (k_global < (1.0 - cfg.exploration) * cfg.num_samples)[:, None]

    x0 = x0.astype(dtype)
    init = (
        jnp.broadcast_to(x0[0], (kloc,)),
        jnp.broadcast_to(x0[1], (kloc,)),
        jnp.broadcast_to(x0[2], (kloc,)),
        jnp.broadcast_to(x0[3], (kloc,)),
        jnp.zeros((kloc,), dtype),
    )

    def body(carry, inp):
        q1, q2, dq1, dq2, s = carry
        u_t, eps_t = inp                       # (2,), (K,2)
        v_t = jnp.where(exploit, u_t + eps_t, eps_t)
        v1, v2 = v_t[:, 0], v_t[:, 1]
        if cfg.u_clamp is not None:            # reference `_g` clamp (Q11)
            v1 = jnp.clip(v1, -cfg.u_clamp, cfg.u_clamp)
            v2 = jnp.clip(v2, -cfg.u_clamp, cfg.u_clamp)
        q1, q2, dq1, dq2 = arm_step(q1, q2, dq1, dq2, v1, v2, cfg.delta_t, arm)
        c = _stage_cost(q1, q2, dq1, dq2, window, valid, stage_w, cfg)
        # γ·uᵀΣ⁻¹v (control.py:106); uses the *unclamped* v like the reference
        # (clamp disabled there) — when clamping is on we use clamped v.
        # (2,); HIGHEST: a GPU may otherwise run a float32 contraction in TF32
        su = jnp.matmul(sigma_inv, u_t, precision=lax.Precision.HIGHEST)
        affine = gamma * (v1 * su[0] + v2 * su[1])
        return (q1, q2, dq1, dq2, s + c + affine), None

    (q1, q2, dq1, dq2, s), _ = lax.scan(
        body, init, (u.astype(dtype), jnp.swapaxes(eps, 0, 1))
    )
    s = s + _stage_cost(q1, q2, dq1, dq2, window, valid, term_w, cfg)
    x_final = jnp.stack([q1, q2, dq1, dq2], axis=-1)
    return s, x_final


def rollout_trajectory(
    arm: ArmParams,
    cfg: MPPIConfig,
    x0: jnp.ndarray,          # (4,)
    v: jnp.ndarray,           # (..., T, 2) control sequences
) -> jnp.ndarray:
    """State trajectories under given controls — viz re-rollouts.

    Reproduces the reference's off-by-one (quirk Q4): the rollout applies
    ``v[..., t-1]`` with t starting at 0, so the LAST control is applied
    first (control.py:132-134, 142-143).  Returns (..., T, 4).
    """
    v = jnp.roll(v, 1, axis=-2)
    batch = v.shape[:-2]
    x0 = x0.astype(v.dtype)
    init = tuple(jnp.broadcast_to(x0[i], batch) for i in range(4))

    def body(carry, v_t):
        q1, q2, dq1, dq2 = carry
        v1, v2 = v_t[..., 0], v_t[..., 1]
        if cfg.u_clamp is not None:
            v1 = jnp.clip(v1, -cfg.u_clamp, cfg.u_clamp)
            v2 = jnp.clip(v2, -cfg.u_clamp, cfg.u_clamp)
        q1, q2, dq1, dq2 = arm_step(q1, q2, dq1, dq2, v1, v2, cfg.delta_t, arm)
        return (q1, q2, dq1, dq2), jnp.stack([q1, q2, dq1, dq2], axis=-1)

    _, traj = lax.scan(body, init, jnp.moveaxis(v, -2, 0))
    return jnp.moveaxis(traj, 0, -2)
