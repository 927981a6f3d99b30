"""2-link planar arm model as batched pure JAX functions.

Re-derivation of the reference plant/controller dynamics
(`utils.py:14-29` = plant, `control.py:234-263` = controller-internal model —
they are two copies of the same equations) in fully batched, elementwise
form: every function accepts arbitrary leading batch dimensions, never builds
2x2 matrices, and inverts the inertia matrix analytically via its 2x2
determinant (no ``linalg.inv``, no dynamic shapes).

Replicated quirks (SURVEY.md §2.2):
  * Q1 — the inertia matrix adds the raw link *lengths* ``+ l1``/``+ l2``
    (utils.py:15-19, control.py:241-245).  Replicated exactly.
  * Semi-implicit Euler: ``dq += ddq·dt`` then ``q += dq_new·dt`` — both the
    plant step (run.py:53-55) and the controller model (control.py:256-259)
    use this order, at different dt (Q2).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import ArmParams


def mass_matrix(q2, p: ArmParams):
    """Elements (M11, M12, M21, M22) of the inertia matrix.

    Reference: utils.py:15-19 / control.py:241-245 (including quirk Q1: the
    ``+ l1`` / ``+ l2`` length terms on the diagonal).
    """
    c2 = jnp.cos(q2)
    m11 = (
        p.m1 * p.lc1 ** 2
        + p.l1
        + p.m2 * (p.l1 ** 2 + p.lc2 ** 2 + 2.0 * p.l1 * p.lc2 * c2)
        + p.l2
    )
    m12 = p.m2 * p.l1 * p.lc2 * c2 + p.m2 * p.lc2 ** 2 + p.l2
    m22 = p.m2 * p.lc2 ** 2 + p.l2
    return m11, m12, m12, m22


def gravity_vector(q1, q2, p: ArmParams):
    """(G1, G2): gravity torques. Reference: utils.py:22-25 / control.py:248-250."""
    c1 = jnp.cos(q1)
    c12 = jnp.cos(q1 + q2)
    g1 = p.m1 * p.lc1 * p.g * c1 + p.m2 * p.g * (p.lc2 * c12 + p.l1 * c1)
    g2 = p.m2 * p.lc2 * p.g * c12
    return g1, g2


def arm_ddq(q1, q2, dq1, dq2, u1, u2, p: ArmParams):
    """Joint accelerations ``ddq = M(q)^-1 (u - C(q,dq)·dq - G(q))``.

    Fully batched scalar-component form of utils.py:14-29 / control.py:241-252
    with the 2x2 inverse done analytically (det = M11·M22 - M12·M21) instead
    of ``np.linalg.inv`` — one reciprocal per sample, no linear algebra calls,
    so XLA keeps everything in a single fused elementwise kernel, and the
    Pallas rollout kernel runs the same code on its lane vectors.
    """
    m11, m12, m21, m22 = mass_matrix(q2, p)
    g1, g2 = gravity_vector(q1, q2, p)
    h = p.m2 * p.l1 * p.lc2 * jnp.sin(q2)
    # C = [[-h·dq2, -h·dq1 - h·dq2], [h·dq1, 0]]   (utils.py:26)
    cdq1 = -h * dq2 * dq1 + (-h * dq1 - h * dq2) * dq2
    cdq2 = h * dq1 * dq1
    r1 = u1 - cdq1 - g1
    r2 = u2 - cdq2 - g2
    det = m11 * m22 - m12 * m21
    inv_det = 1.0 / det
    ddq1 = (m22 * r1 - m12 * r2) * inv_det
    ddq2 = (-m21 * r1 + m11 * r2) * inv_det
    return ddq1, ddq2


def arm_step(q1, q2, dq1, dq2, u1, u2, dt, p: ArmParams):
    """One semi-implicit Euler step: dq += ddq·dt, then q += dq_new·dt.

    Matches both the controller model `_F` (control.py:256-259, dt=delta_t)
    and the plant update (run.py:53-55, dt=sim dt) — quirk Q2 is preserved by
    the caller choosing dt.
    """
    ddq1, ddq2 = arm_ddq(q1, q2, dq1, dq2, u1, u2, p)
    dq1n = dq1 + ddq1 * dt
    dq2n = dq2 + ddq2 * dt
    q1n = q1 + dq1n * dt
    q2n = q2 + dq2n * dt
    return q1n, q2n, dq1n, dq2n


def arm_step_fblin(q1, q2, dq1, dq2, v1, v2, dt, p: ArmParams):
    """The reference's `_F1` variant (control.py:265-295, dead code, C15):
    one semi-implicit Euler step where the input v is a commanded
    ACCELERATION, pre-compensated by feedback linearization with gravity
    zeroed.

    The reference computes u = M·v + C·dq + G then ddq = M⁻¹(u − C·dq − G)
    with g1 = g2 = 0 (control.py:280-284) — the two cancel analytically, so
    ddq == v exactly and the step is a pure double integrator.  We compose
    the same two operations from the shared building blocks (so the
    cancellation happens through the real M/C arithmetic, like the
    reference) rather than shortcutting to ddq = v.

    Never called by the closed loop — provided for API completeness; the
    reference never calls `_F1` either (SURVEY.md C15).
    """
    import dataclasses as _dc
    p0 = _dc.replace(p, g=0.0)
    u1, u2 = feedback_linearization(q1, q2, dq1, dq2, v1, v2, p0)
    ddq1, ddq2 = arm_ddq(q1, q2, dq1, dq2, u1, u2, p0)
    dq1n = dq1 + ddq1 * dt
    dq2n = dq2 + ddq2 * dt
    q1n = q1 + dq1n * dt
    q2n = q2 + dq2n * dt
    return q1n, q2n, dq1n, dq2n


def fk_ee(q1, q2, l1, l2):
    """End-effector position (x2, y2). Reference: utils.py:35-36 /
    control.py:178-179 (the cost FK hardcodes l1=l2=1, control.py:55-56)."""
    x = l1 * jnp.cos(q1) + l2 * jnp.cos(q1 + q2)
    y = l1 * jnp.sin(q1) + l2 * jnp.sin(q1 + q2)
    return x, y


def fk_full(q1, q2, p: ArmParams):
    """Elbow and end-effector positions (x1, y1, x2, y2). utils.py:32-38."""
    x1 = p.l1 * jnp.cos(q1)
    y1 = p.l1 * jnp.sin(q1)
    x2 = x1 + p.l2 * jnp.cos(q1 + q2)
    y2 = y1 + p.l2 * jnp.sin(q1 + q2)
    return x1, y1, x2, y2


def ik_circle(theta, l1: float = 1.0, l2: float = 1.0,
              closure_overrides: bool = True):
    """Closed-form IK for the reference circle path (utils.py:41-62).

    The circle is XE = 0.8 + 0.6·cosθ, YE = 0.8 + 0.6·sinθ with two piecewise
    overrides near θ≈2π (utils.py:47-52), then a 2-link arctan IK.  Returns
    (r, XE, YE) where r = [x1d, x2d - x1d] are the joint-angle targets.
    Batched over theta; the piecewise overrides become ``jnp.where`` masks.

    ``closure_overrides=False`` skips the θ≈2π overrides and evaluates the
    pure circle — required for multi-revolution paths, where the reference's
    single-revolution closure logic would pin every θ > 2π+0.2 at the
    singular fully-extended pose (2, 0) and produce a degenerate path.
    """
    theta = jnp.asarray(theta)
    xe = 0.8 + 0.6 * jnp.cos(theta)
    ye = 0.8 + 0.6 * jnp.sin(theta)
    if closure_overrides:
        two_pi = 2.0 * jnp.pi
        near_close = (theta >= two_pi - 0.2) & (theta <= two_pi + 0.2)
        past = theta > two_pi + 0.2
        xe = jnp.where(near_close, 1.4, xe)
        ye = jnp.where(near_close, 0.8, ye)
        xe = jnp.where(past, 2.0, xe)
        ye = jnp.where(past, 0.0, ye)

    term = jnp.sqrt(
        -(xe ** 4)
        - 2.0 * xe ** 2 * ye ** 2
        + 2.0 * xe ** 2 * l1 ** 2
        + 2.0 * xe ** 2 * l2 ** 2
        - ye ** 4
        + 2.0 * ye ** 2 * l1 ** 2
        + 2.0 * ye ** 2 * l2 ** 2
        - l1 ** 4
        + 2.0 * l1 ** 2 * l2 ** 2
        - l2 ** 4
    )
    denom = xe ** 2 + 2.0 * xe * l1 + ye ** 2 + l1 ** 2 - l2 ** 2
    x1d = 2.0 * jnp.arctan((2.0 * ye * l1 + term) / denom)
    x2d = 2.0 * jnp.arctan((2.0 * ye * l1 - term) / denom)
    r = jnp.stack([x1d, x2d - x1d], axis=-1)
    return r, xe, ye


def feedback_linearization(q1, q2, dq1, dq2, v1, v2, p: ArmParams):
    """Computed-torque law ``u = M·v + C·dq + G`` (utils.py:65-84).

    Kept for parity with the reference's legacy control path (SURVEY.md §3.5);
    the xydq_circle.txt torque columns are consistent with this law.
    """
    m11, m12, m21, m22 = mass_matrix(q2, p)
    g1, g2 = gravity_vector(q1, q2, p)
    h = p.m2 * p.l1 * p.lc2 * jnp.sin(q2)
    cdq1 = -h * dq2 * dq1 + (-h * dq1 - h * dq2) * dq2
    cdq2 = h * dq1 * dq1
    u1 = m11 * v1 + m12 * v2 + cdq1 + g1
    u2 = m21 * v1 + m22 * v2 + cdq2 + g2
    return u1, u2


def pd_outer_loop(q, dq, r, dr, ddr, kp: float = 100.0, kd: float = 20.0):
    """Outer-loop PD law ``v = ddr - KD·(dq-dr) - KP·(q-r)`` (utils.py:87-93)."""
    return ddr - kd * (dq - dr) - kp * (q - r)
