"""Closed-loop integration tests (SURVEY.md §4.3): scan sim vs oracle loop."""

import numpy as np
import jax
import jax.numpy as jnp

from mppi_robotarm.config import ArmParams, MPPIConfig, SimConfig
from mppi_robotarm.ops.noise import sample_epsilon, sigma_cholesky
from mppi_robotarm.sim.loop import init_sim, simulate, simulate_python
from oracle import OracleMPPI, oracle_closed_loop

ARM = ArmParams()
CFG = MPPIConfig()
SIM = SimConfig()
N_STEPS = 20


def test_closed_loop_parity_f64(ref_path):
    """20 closed-loop steps with injected noise match the oracle loop
    (run.py:48-71 semantics incl. the dt vs 2dt mismatch, Q2)."""
    # Dedicated generator (NOT the session-scoped rng fixture): the chaotic
    # loop amplifies f64 summation-order noise by ~x1.5/step, so the step-14+
    # tolerances below only hold for a fixed noise realisation.  Drawing from
    # the shared fixture made the stream depend on which tests ran earlier.
    gen = np.random.default_rng(0)
    eps_list = [gen.normal(size=(CFG.num_samples, CFG.horizon, 2))
                * np.sqrt(20.0) for _ in range(N_STEPS)]
    oracle = OracleMPPI(ref_path)
    recs_exp = oracle_closed_loop(oracle, SIM.q0, SIM.dq0, SIM.dt, N_STEPS,
                                  eps_list)

    state = init_sim(CFG, SIM, jax.random.PRNGKey(0), dtype=jnp.float64)
    _, recs = simulate_python(ARM, CFG, SIM, jnp.asarray(ref_path), state,
                              N_STEPS,
                              eps_per_step=[jnp.asarray(e) for e in eps_list])
    for i in range(N_STEPS):
        q_got, dq_got, u_got, idx_got = recs[i]
        q_exp, dq_exp, u_exp, idx_exp = recs_exp[i]
        np.testing.assert_allclose(q_got, q_exp, rtol=1e-7, atol=1e-9,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(dq_got, dq_exp, rtol=1e-6, atol=1e-8,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(u_got, u_exp, rtol=1e-7, atol=1e-7,
                                   err_msg=f"step {i}")
        assert idx_got == idx_exp, f"step {i}"


def test_scan_sim_matches_python_driver(ref_path):
    """The lax.scan-compiled loop == the host-loop driver, same noise."""
    steps = 8
    key0 = jax.random.PRNGKey(42)
    state0 = init_sim(CFG, SIM, key0, dtype=jnp.float64)
    _, rec = simulate(ARM, CFG, SIM, jnp.asarray(ref_path), state0, steps)

    # replay the scan's key-split sequence on the host
    chol = sigma_cholesky(CFG.sigma)
    key = key0
    eps_list = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        eps_list.append(sample_epsilon(sub, CFG.num_samples, CFG.horizon,
                                       chol, jnp.float64))
    state0b = init_sim(CFG, SIM, key0, dtype=jnp.float64)
    _, recs_py = simulate_python(ARM, CFG, SIM, jnp.asarray(ref_path), state0b,
                                 steps, eps_per_step=eps_list)
    for i in range(steps):
        np.testing.assert_allclose(np.asarray(rec.q[i]), recs_py[i][0],
                                   rtol=1e-9, atol=1e-12, err_msg=f"step {i}")
        np.testing.assert_allclose(np.asarray(rec.u[i]), recs_py[i][2],
                                   rtol=1e-9, atol=1e-10, err_msg=f"step {i}")


def test_tracking_error_sane(ref_path):
    """Config-1-style gate: closed-loop EE error stays in the mm range
    (reference measured ~0.9 mm mean over the first 30 steps, BASELINE.md)."""
    steps = 30
    state0 = init_sim(CFG, SIM, jax.random.PRNGKey(1), dtype=jnp.float64)
    _, rec = simulate(ARM, CFG, SIM, jnp.asarray(ref_path), state0, steps)
    ee = np.asarray(rec.ee)
    ref = ref_path[1:steps + 1, 0:2]
    err = np.linalg.norm(ee - ref, axis=1)
    assert err.mean() < 5e-3, f"mean EE error {err.mean()*1e3:.2f} mm"
    assert not bool(rec.done[-1])


def test_disturbance_injection(ref_path):
    """SURVEY.md §5.3: the plant disturbance hook perturbs the trajectory."""
    import dataclasses
    sim_d = dataclasses.replace(SIM, disturbance=(5.0, -5.0))
    s0 = init_sim(CFG, SIM, jax.random.PRNGKey(2), dtype=jnp.float64)
    _, rec_a = simulate(ARM, CFG, SIM, jnp.asarray(ref_path), s0, 5)
    s0b = init_sim(CFG, sim_d, jax.random.PRNGKey(2), dtype=jnp.float64)
    _, rec_b = simulate(ARM, CFG, sim_d, jnp.asarray(ref_path), s0b, 5)
    assert not np.allclose(np.asarray(rec_a.q), np.asarray(rec_b.q))


def test_ref_path_from_joint_log():
    """trajectory.txt (C26) converts to a usable [x,y,dq1,dq2] path and a
    single solve can track it (BASELINE config 1)."""
    import os
    import dataclasses
    from mppi_robotarm.sim.paths import (load_joint_log,
                                             ref_path_from_joint_log)
    src = "/root/reference/trajectory.txt"
    if os.path.exists(src):
        log = load_joint_log(src, dtype=np.float64)
    else:
        t = np.linspace(0, 1, 500)
        q1, q2 = 1.15 + 0.1 * t, -1.27 + 0.1 * t
        log = np.stack([q1, q2, np.cos(q1) + np.cos(q1 + q2),
                        np.sin(q1) + np.sin(q1 + q2)], axis=1)
    ref = ref_path_from_joint_log(log, dtype=np.float64)
    assert ref.shape == (log.shape[0], 4)
    np.testing.assert_allclose(ref[:, 0], log[:, 2], rtol=1e-12)

    from mppi_robotarm.mppi.solver import init_state, solve
    cfg = dataclasses.replace(CFG, num_samples=256, horizon=30)
    x0 = jnp.asarray([log[0, 0], log[0, 1], 0.0, 0.0])
    eps = np.random.default_rng(5).normal(
        size=(256, 30, 2)) * np.sqrt(20.0)
    res = solve(ARM, cfg, jnp.asarray(ref), x0,
                init_state(cfg, dtype=jnp.float64), eps=jnp.asarray(eps))
    assert np.all(np.isfinite(np.asarray(res.u0)))
    assert not bool(res.path_end)


def test_closed_loop_parity_f64_long(ref_path):
    """80-step closed-loop golden parity with chaos-aware tolerances.

    The closed loop is mildly chaotic: float64 summation-order differences
    (~1e-15) between the JAX solver and the NumPy oracle amplify by ~x1.5
    per step (measured: 3e-15 @ step 20, 4e-11 @ 40, 9e-7 @ 60, 1.5e-5 @
    75 — smooth exponential, no discrete jumps).  The *discrete* structure
    (waypoint indices) stays identical throughout, which is the strongest
    cross-implementation check available at this horizon; continuous-state
    tolerances follow the Lyapunov envelope."""
    steps = 80
    # dedicated generator: the Lyapunov-envelope tolerances below are
    # calibrated against THIS noise stream (order-independent of other tests)
    gen = np.random.default_rng(0)
    eps_list = [gen.normal(size=(CFG.num_samples, CFG.horizon, 2))
                * np.sqrt(20.0) for _ in range(steps)]
    oracle = OracleMPPI(ref_path)
    recs_exp = oracle_closed_loop(oracle, SIM.q0, SIM.dq0, SIM.dt, steps,
                                  eps_list)
    state = init_sim(CFG, SIM, jax.random.PRNGKey(0), dtype=jnp.float64)
    _, recs = simulate_python(ARM, CFG, SIM, jnp.asarray(ref_path), state,
                              steps,
                              eps_per_step=[jnp.asarray(e) for e in eps_list])
    for i in range(steps):
        assert recs[i][3] == recs_exp[i][3], f"wp idx diverged at step {i}"
    tol = {20: 1e-12, 40: 1e-9, 60: 1e-5, 79: 1e-3}
    for i, atol in tol.items():
        np.testing.assert_allclose(recs[i][0], recs_exp[i][0], atol=atol,
                                   err_msg=f"step {i}")


def test_solver_health_metrics_in_record(ref_path):
    """The closed loop reports ESS and weight entropy per step (§5.5, W7)."""
    import dataclasses as dc
    cfg = dc.replace(MPPIConfig(), num_samples=64, horizon=8)
    state0 = init_sim(cfg, SIM, jax.random.PRNGKey(0))
    _, rec = simulate(ARM, cfg, SIM, jnp.asarray(ref_path, jnp.float32),
                      state0, 10)
    ess = np.asarray(rec.ess)
    ent = np.asarray(rec.weight_entropy)
    assert ess.shape == (10,) and ent.shape == (10,)
    assert np.all((ess >= 1.0) & (ess <= cfg.num_samples + 1e-3))
    assert np.all((ent >= -1e-6) & (ent <= np.log(cfg.num_samples) + 1e-3))


def test_chunked_run_matches_full(ref_path):
    """Two chunked simulate() calls (the CLI's --checkpoint-every path)
    concatenate to the uninterrupted run bitwise — INCLUDING the step-aligned
    ref_xy rows (regression: scan-local ref indexing desynced resumed
    records from the reference's global run.py:65-66 row k)."""
    import dataclasses as dc
    cfg = dc.replace(MPPIConfig(), num_samples=64, horizon=8)
    ref_j = jnp.asarray(ref_path, jnp.float32)

    s_full = init_sim(cfg, SIM, jax.random.PRNGKey(7))
    _, rec_full = simulate(ARM, cfg, SIM, ref_j, s_full, 16)

    state = init_sim(cfg, SIM, jax.random.PRNGKey(7))
    parts = []
    for _ in range(2):
        state, rec = simulate(ARM, cfg, SIM, ref_j, state, 8)
        parts.append(rec)
    rec_chunk = jax.tree.map(lambda *xs: jnp.concatenate(xs, 0), *parts)
    assert int(state.step) == 16
    for f in rec_full._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(rec_chunk, f)),
            np.asarray(getattr(rec_full, f)), err_msg=f)


def test_chunked_batch_matches_full(ref_path):
    """Scenario-batched chunked runs stay step-aligned per scenario too."""
    import dataclasses as dc
    from mppi_robotarm.sim.loop import init_sim_batch, simulate_batch

    cfg = dc.replace(MPPIConfig(), num_samples=64, horizon=8)
    ref_j = jnp.asarray(ref_path, jnp.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(3))

    s_full = init_sim_batch(cfg, SIM, keys)
    _, rec_full = simulate_batch(ARM, cfg, SIM, ref_j, s_full, 12)

    states = init_sim_batch(cfg, SIM, keys)
    parts = []
    for _ in range(2):
        states, rec = simulate_batch(ARM, cfg, SIM, ref_j, states, 6)
        parts.append(rec)
    rec_chunk = jax.tree.map(lambda *xs: jnp.concatenate(xs, 0), *parts)
    for f in rec_full._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(rec_chunk, f)),
            np.asarray(getattr(rec_full, f)), err_msg=f)


def test_xydq_alternate_path_closed_loop():
    """C25 end-to-end (round-3 VERDICT item 8): track the reference's
    alternate path xydq.txt — a straight fold-in along the x axis that
    STARTS at the fully-extended singular pose q=(0,0), EE=(2,0), a
    genuinely different regime from the circle (at the singularity the
    Jacobian loses rank and the EE cannot move radially outward).

    Measured bound (CPU xla backend, seed 0, 150 steps): on-path mean
    2.44 mm / max 14.8 mm, wp index 169.  Gated at 3x: the run must track
    the fold within 10 mm mean and make real progress along the path.
    """
    import dataclasses
    import os

    import pytest

    src = "/root/reference/xydq.txt"
    if not os.path.exists(src):
        pytest.skip("reference xydq.txt not mounted")
    from mppi_robotarm.sim.paths import load_ref_path

    ref = load_ref_path(src, dtype=np.float64)
    assert ref.shape == (2000, 4)
    np.testing.assert_allclose(ref[0, 0:2], [2.0, 0.0], atol=1e-6)

    sim = dataclasses.replace(SIM, q0=(0.0, 0.0), dq0=(0.0, 0.0))
    steps = 150
    s0 = init_sim(CFG, sim, jax.random.PRNGKey(0), dtype=jnp.float64)
    _, rec = simulate(ARM, CFG, sim, jnp.asarray(ref), s0, steps)

    ee = np.asarray(rec.ee)
    on_path = np.linalg.norm(ee[:, None, :] - ref[None, :, 0:2],
                             axis=-1).min(axis=1)
    assert on_path.mean() < 0.010, (
        f"on-path mean {on_path.mean() * 1e3:.2f} mm (measured 2.44 mm)")
    wp = np.asarray(rec.wp_idx)
    assert wp[-1] > 100, f"no progress along the fold: wp={wp[-1]}"
    assert (np.diff(wp) >= 0).all()          # monotone frozen-index advance
    assert not bool(rec.done[-1])
    # the fold is symmetric: q2 ~ -2 q1 along the path (elbow folds twice
    # as fast as the shoulder rises) — a loose structural check that the
    # arm is folding, not wandering
    q = np.asarray(rec.q)
    assert np.abs(q[-1, 1] + 2.0 * q[-1, 0]) < 0.1


def test_high_accuracy_preset_runs():
    """The round-4 accuracy preset (delta_t matched to the plant, Q2
    relaxed) is a valid configuration and its closed loop runs; its
    measured quality (6.1 mm vs 12.6 mm at the reference's
    delta_t=0.006, K=1024/H=50) is documented in docs/PARITY_RUN.md."""
    import dataclasses
    from mppi_robotarm.config import high_accuracy_preset

    arm, cfg, sim = high_accuracy_preset()
    assert (cfg.delta_t, cfg.horizon, cfg.num_samples) == (0.003, 50, 1024)
    cfg.validate()
    # tiny-shape smoke of the full loop under this delta_t
    cfg = dataclasses.replace(cfg, num_samples=32, horizon=8)
    from mppi_robotarm.sim.paths import synth_circle_path
    ref = jnp.asarray(synth_circle_path(300), jnp.float64)
    s0 = init_sim(cfg, sim, jax.random.PRNGKey(0), dtype=jnp.float64)
    _, rec = simulate(arm, cfg, sim, ref, s0, 10)
    assert np.all(np.isfinite(np.asarray(rec.q)))
