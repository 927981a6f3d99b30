"""Golden-parity tests of the MPPI solve vs the NumPy oracle (SURVEY.md §4.1)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from mppi_robotarm.config import ArmParams, MPPIConfig
from mppi_robotarm.mppi.solver import MPPIState, init_state, solve
from oracle import OracleMPPI

ARM = ArmParams()
CFG = MPPIConfig()  # the run.py:25-37 circle-tracking preset (K=100, T=30)
X0 = np.array([1.152198236517471885, -1.266101672070702344, 0.0, 0.0])


def _eps(rng, k, t):
    return rng.normal(size=(k, t, 2)) * np.sqrt(20.0)


def test_single_solve_parity_f64(ref_path, rng):
    eps = _eps(rng, CFG.num_samples, CFG.horizon)
    oracle = OracleMPPI(ref_path)
    u0_exp, useq_exp, s_exp, w_exp = oracle.solve(X0, eps)

    state = init_state(CFG, dtype=jnp.float64)
    res = solve(ARM, CFG, jnp.asarray(ref_path), jnp.asarray(X0), state,
                eps=jnp.asarray(eps))
    np.testing.assert_allclose(res.costs, s_exp, rtol=1e-9)
    np.testing.assert_allclose(res.weights, w_exp, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res.u_seq, useq_exp, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(res.u0, u0_exp, rtol=1e-9, atol=1e-9)
    assert int(res.state.wp_idx) == oracle.prev_idx
    np.testing.assert_allclose(res.state.u_prev, oracle.u_prev, rtol=1e-9,
                               atol=1e-9)
    assert not bool(res.path_end)


def test_three_successive_solves_parity(ref_path, rng):
    """Warm-start shift (Q3) + frozen-index advance (Q5) across solves."""
    oracle = OracleMPPI(ref_path)
    state = init_state(CFG, dtype=jnp.float64)
    x = X0.copy()
    for i in range(3):
        eps = _eps(rng, CFG.num_samples, CFG.horizon)
        u0_exp, _, _, _ = oracle.solve(x, eps)
        res = solve(ARM, CFG, jnp.asarray(ref_path), jnp.asarray(x), state,
                    eps=jnp.asarray(eps))
        np.testing.assert_allclose(res.u0, u0_exp, rtol=1e-8, atol=1e-8)
        assert int(res.state.wp_idx) == oracle.prev_idx
        state = res.state
        # perturb the observed state a little between solves
        x = x + np.array([0.002, -0.001, 0.05, 0.03]) * (i + 1)


def test_exploration_split(ref_path, rng):
    """Q9: with exploration > 0 the tail samples use pure ε."""
    cfg = dataclasses.replace(CFG, exploration=0.3)
    eps = _eps(rng, cfg.num_samples, cfg.horizon)
    oracle = OracleMPPI(ref_path, exploration=0.3)
    u0_exp, _, s_exp, _ = oracle.solve(X0, eps)
    res = solve(ARM, cfg, jnp.asarray(ref_path), jnp.asarray(X0),
                init_state(cfg, dtype=jnp.float64), eps=jnp.asarray(eps))
    np.testing.assert_allclose(res.costs, s_exp, rtol=1e-9)
    np.testing.assert_allclose(res.u0, u0_exp, rtol=1e-9, atol=1e-9)


def test_u_clamp(ref_path, rng):
    """Q11: the reference's disabled clamp, re-enabled as config."""
    cfg = dataclasses.replace(CFG, u_clamp=0.8)
    eps = _eps(rng, cfg.num_samples, cfg.horizon)
    res = solve(ARM, cfg, jnp.asarray(ref_path), jnp.asarray(X0),
                init_state(cfg, dtype=jnp.float64), eps=jnp.asarray(eps))
    assert np.all(np.isfinite(np.asarray(res.costs)))


def test_path_end_flag(ref_path, rng):
    """Q6: wp_idx at the last waypoint sets path_end (reference IndexError)."""
    n = ref_path.shape[0]
    # place the arm's EE exactly at the final waypoint
    state = MPPIState(u_prev=init_state(CFG, dtype=jnp.float64).u_prev,
                      wp_idx=jnp.asarray(n - 3, jnp.int32))
    tx, ty = ref_path[n - 1, 0], ref_path[n - 1, 1]
    # IK for the end point (elbow-down solution)
    d2 = tx * tx + ty * ty
    c2 = np.clip((d2 - 2.0) / 2.0, -1, 1)
    q2 = np.arccos(c2)
    q1 = np.arctan2(ty, tx) - np.arctan2(np.sin(q2), 1 + np.cos(q2))
    x = np.array([q1, q2, 0.0, 0.0])
    eps = _eps(rng, CFG.num_samples, CFG.horizon)
    res = solve(ARM, CFG, jnp.asarray(ref_path), jnp.asarray(x), state,
                eps=jnp.asarray(eps))
    assert bool(res.path_end)


def test_determinism_same_key(ref_path):
    """Same PRNG key ⇒ bitwise-identical output (SURVEY.md §4.5)."""
    key = jax.random.PRNGKey(7)
    state = init_state(CFG)
    r1 = solve(ARM, CFG, jnp.asarray(ref_path, jnp.float32),
               jnp.asarray(X0, jnp.float32), state, key=key)
    r2 = solve(ARM, CFG, jnp.asarray(ref_path, jnp.float32),
               jnp.asarray(X0, jnp.float32), state, key=key)
    np.testing.assert_array_equal(np.asarray(r1.u_seq), np.asarray(r2.u_seq))
    np.testing.assert_array_equal(np.asarray(r1.costs), np.asarray(r2.costs))


def test_f32_accuracy_within_gate(ref_path, rng):
    """fp32 (the accelerator's precision) vs float64 oracle stays within
    the 1e-3 gate (BASELINE.json control-parity tolerance)."""
    eps = _eps(rng, CFG.num_samples, CFG.horizon)
    oracle = OracleMPPI(ref_path)
    u0_exp, useq_exp, _, _ = oracle.solve(X0, eps)
    res = solve(ARM, CFG, jnp.asarray(ref_path, jnp.float32),
                jnp.asarray(X0, jnp.float32), init_state(CFG),
                eps=jnp.asarray(eps, jnp.float32))
    np.testing.assert_allclose(np.asarray(res.u0), u0_exp, atol=1e-3)
    np.testing.assert_allclose(np.asarray(res.u_seq), useq_exp, atol=1e-3)


def test_sigma_validation():
    import pytest
    bad = dataclasses.replace(CFG, sigma=((1.0, 0.0, 0.0), (0.0, 1.0, 0.0)))
    with pytest.raises(ValueError):
        bad.validate()
