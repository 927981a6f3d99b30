"""Unit tests of the arm model vs the NumPy oracle (SURVEY.md §4.2)."""

import numpy as np
import jax.numpy as jnp

from mppi_robotarm.config import ArmParams
from mppi_robotarm.models import arm as arm_mod
from oracle import oracle_ddq, oracle_step, oracle_fk

ARM = ArmParams()


def _rand_state(rng, n=64):
    q = rng.uniform(-np.pi, np.pi, size=(2, n))
    dq = rng.uniform(-5.0, 5.0, size=(2, n))
    u = rng.uniform(-30.0, 30.0, size=(2, n))
    return q, dq, u


def test_ddq_matches_oracle(rng):
    q, dq, u = _rand_state(rng)
    got1, got2 = arm_mod.arm_ddq(*map(jnp.asarray, (q[0], q[1], dq[0], dq[1],
                                                    u[0], u[1])), ARM)
    exp1, exp2 = oracle_ddq(q[0], q[1], dq[0], dq[1], u[0], u[1])
    np.testing.assert_allclose(got1, exp1, rtol=1e-12)
    np.testing.assert_allclose(got2, exp2, rtol=1e-12)


def test_ddq_matches_linalg_inverse(rng):
    """Analytic 2x2 inverse == np.linalg.inv-based formulation (utils.py:27)."""
    q, dq, u = _rand_state(rng, n=16)
    for i in range(16):
        m11, m12, m21, m22 = [np.asarray(v) for v in
                              arm_mod.mass_matrix(jnp.asarray(q[1, i]), ARM)]
        M = np.array([[m11, m12], [m21, m22]])
        h = ARM.m2 * ARM.l1 * ARM.lc2 * np.sin(q[1, i])
        C = np.array([[-h * dq[1, i], -h * dq[0, i] - h * dq[1, i]],
                      [h * dq[0, i], 0.0]])
        g1, g2 = [np.asarray(v) for v in
                  arm_mod.gravity_vector(jnp.asarray(q[0, i]),
                                         jnp.asarray(q[1, i]), ARM)]
        expected = np.linalg.inv(M) @ (u[:, i] - C @ dq[:, i]
                                       - np.array([g1, g2]))
        got = arm_mod.arm_ddq(*[jnp.asarray(v) for v in
                                (q[0, i], q[1, i], dq[0, i], dq[1, i],
                                 u[0, i], u[1, i])], ARM)
        np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-10)


def test_step_matches_oracle(rng):
    q, dq, u = _rand_state(rng)
    x = np.stack([q[0], q[1], dq[0], dq[1]], axis=-1)
    uu = np.stack([u[0], u[1]], axis=-1)
    got = arm_mod.arm_step(*map(jnp.asarray, (q[0], q[1], dq[0], dq[1],
                                              u[0], u[1])), 0.006, ARM)
    exp = oracle_step(x, uu, 0.006)
    got = np.stack([np.asarray(g) for g in got], axis=-1)
    np.testing.assert_allclose(got, exp, rtol=1e-12)


def test_fk(rng):
    q, _, _ = _rand_state(rng)
    x, y = arm_mod.fk_ee(jnp.asarray(q[0]), jnp.asarray(q[1]), 1.0, 1.0)
    ex, ey = oracle_fk(q[0], q[1])
    np.testing.assert_allclose(x, ex, rtol=1e-12)
    np.testing.assert_allclose(y, ey, rtol=1e-12)
    x1, y1, x2, y2 = arm_mod.fk_full(jnp.asarray(q[0]), jnp.asarray(q[1]), ARM)
    np.testing.assert_allclose(x2, ex, rtol=1e-12)
    np.testing.assert_allclose(np.hypot(np.asarray(x1), np.asarray(y1)), 1.0,
                               rtol=1e-12)


def test_ik_circle_piecewise():
    """IK matches the reference's piecewise circle (utils.py:41-62), and
    FK(IK(θ)) returns the circle point."""
    thetas = np.array([0.0, 1.0, 2.5, 2 * np.pi - 0.3, 2 * np.pi - 0.1,
                       2 * np.pi + 0.1, 2 * np.pi + 0.3])
    r, xe, ye = arm_mod.ik_circle(jnp.asarray(thetas))
    xe, ye = np.asarray(xe), np.asarray(ye)
    # piecewise overrides
    np.testing.assert_allclose(xe[4], 1.4)
    np.testing.assert_allclose(ye[4], 0.8)
    np.testing.assert_allclose(xe[6], 2.0)
    np.testing.assert_allclose(ye[6], 0.0)
    # circle region
    np.testing.assert_allclose(xe[1], 0.8 + 0.6 * np.cos(1.0), rtol=1e-12)
    # FK round-trip (skip the singular fully-extended point)
    r = np.asarray(r)
    for i in range(6):
        x, y = oracle_fk(r[i, 0], r[i, 0] + (r[i, 1]))
        fx = np.cos(r[i, 0]) + np.cos(r[i, 0] + r[i, 1])
        fy = np.sin(r[i, 0]) + np.sin(r[i, 0] + r[i, 1])
        np.testing.assert_allclose([fx, fy], [xe[i], ye[i]], atol=1e-9)


def test_feedback_linearization_inverts_dynamics(rng):
    """u = M·v + C·dq + G  ⇒  ddq(u) == v (computed-torque property)."""
    q, dq, _ = _rand_state(rng, n=32)
    v = np.random.default_rng(3).uniform(-10, 10, size=(2, 32))
    u1, u2 = arm_mod.feedback_linearization(
        *map(jnp.asarray, (q[0], q[1], dq[0], dq[1], v[0], v[1])), ARM)
    dd1, dd2 = arm_mod.arm_ddq(
        *map(jnp.asarray, (q[0], q[1], dq[0], dq[1])), u1, u2, ARM)
    np.testing.assert_allclose(dd1, v[0], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(dd2, v[1], rtol=1e-8, atol=1e-8)


def test_pd_outer_loop():
    v = arm_mod.pd_outer_loop(jnp.asarray([1.0, 2.0]), jnp.asarray([0.5, 0.1]),
                              jnp.asarray([0.9, 2.1]), jnp.asarray([0.0, 0.0]),
                              jnp.asarray([0.0, 0.0]))
    # v = ddr - 20(dq-dr) - 100(q-r)   (utils.py:87-93)
    np.testing.assert_allclose(v, [0.0 - 20 * 0.5 - 100 * 0.1,
                                   0.0 - 20 * 0.1 - 100 * (-0.1)],
                               rtol=1e-12)


def test_arm_step_fblin_is_double_integrator():
    """The `_F1` variant (control.py:265-295, C15): feedback linearization
    with zeroed gravity composed with the zero-gravity dynamics cancels
    analytically, so the step is a pure double integrator ddq == v."""
    gen = np.random.default_rng(9)
    q, dq, v = gen.normal(size=(3, 2))
    dt = 0.006
    q1n, q2n, dq1n, dq2n = arm_mod.arm_step_fblin(
        *map(jnp.asarray, (q[0], q[1], dq[0], dq[1], v[0], v[1])), dt, ARM)
    dq_exp = dq + v * dt
    q_exp = q + dq_exp * dt
    np.testing.assert_allclose([dq1n, dq2n], dq_exp, rtol=1e-10)
    np.testing.assert_allclose([q1n, q2n], q_exp, rtol=1e-10)


def test_ik_circle_multi_revolution_paths_are_smooth():
    """revolutions > 1 must skip the reference's single-revolution closure
    overrides (utils.py:47-52) — with them every θ > 2π+0.2 pins the path
    at the singular (2, 0) pose and the synthesized path degenerates."""
    import numpy as np
    from mppi_robotarm.sim.paths import synth_circle_path

    multi = np.asarray(synth_circle_path(4000, revolutions=4.0))
    d = np.linalg.norm(np.diff(multi[:, :2], axis=0), axis=1)
    assert d.max() < 3 * np.median(d), "multi-rev path has discontinuities"
    assert np.abs(multi[:, 2:]).max() < 10, "dq references blew up"
    # single revolution keeps the reference's closure quirk (parity):
    # the θ ∈ [2π-0.2, 2π] rows are pinned to (1.4, 0.8) (utils.py:47-49)
    single = np.asarray(synth_circle_path(2000, revolutions=1.0))
    pinned = np.isclose(single[:, 0], 1.4, atol=1e-6) & np.isclose(
        single[:, 1], 0.8, atol=1e-6)
    assert pinned[-30:].all(), \
        "closure override rows missing from the single-rev path"


def test_ik_term_in_domain_for_all_shipped_generators():
    """The IK closed form takes a RAW sqrt (ik_circle's ``term``,
    utils.py:54): outside the reachable annulus |l1-l2| <= rho <= l1+l2 it
    goes NaN, exactly as the reference does.  The framework additionally
    advertises multi-revolution / synthetic paths, so this pins the
    in-domain guarantee for every SHIPPED generator: each emitted waypoint
    stays inside the annulus (finite IK), and the assertion here is the one
    that would catch a future generator emitting an unreachable waypoint
    (round-4 VERDICT item 8)."""
    from mppi_robotarm.sim.pathgen import generate_circle_path
    from mppi_robotarm.sim.paths import synth_circle_path

    l1, l2 = ARM.l1, ARM.l2
    lo, hi = abs(l1 - l2), l1 + l2

    def assert_in_domain(xy, name):
        assert np.isfinite(xy).all(), f"{name}: non-finite waypoints"
        rho = np.hypot(xy[:, 0], xy[:, 1])
        assert (rho >= lo - 1e-6).all() and (rho <= hi + 1e-6).all(), (
            f"{name}: waypoint outside the reachable annulus "
            f"[{lo}, {hi}]: rho range [{rho.min()}, {rho.max()}]")

    # synth_circle_path: single rev (closure overrides incl. the boundary
    # (2,0) pose where term == 0 exactly), tiny arc, and multi-revolution
    for rev, n in ((1.0, 2000), (0.02, 40), (3.0, 1500)):
        p = np.asarray(synth_circle_path(n, revolutions=rev))
        assert np.isfinite(p).all(), f"synth rev={rev}: non-finite rows"
        assert_in_domain(p[:, 0:2], f"synth_circle_path(rev={rev})")

    # the legacy computed-torque pipeline (xydq_circle.txt format): the IK
    # targets AND their jacfwd derivatives must stay finite over the run
    rows = np.asarray(generate_circle_path(ARM, num_steps=500))
    assert np.isfinite(rows).all(), "generate_circle_path: non-finite rows"
    assert_in_domain(rows[:, 0:2], "generate_circle_path")

    # the boundary pose itself is exact, not NaN: the closure override pins
    # (2, 0) where the radicand is 0 by cancellation of exact f32 integers
    r, xe, ye = arm_mod.ik_circle(jnp.asarray([2.0 * np.pi + 0.3]))
    assert np.isfinite(np.asarray(r)).all() and float(xe[0]) == 2.0

    # and the NaN edge is REAL (documented, reference-matching): the same
    # circle is unreachable for a shorter arm, so the raw sqrt goes NaN —
    # this is what the finiteness assertions above would catch
    r_bad, _, _ = arm_mod.ik_circle(jnp.asarray([0.7]), l1=0.5, l2=0.5)
    assert np.isnan(np.asarray(r_bad)).any()
