"""Legacy path-generation pipeline + single-chip scenario batching."""

import os

import numpy as np
import jax
import jax.numpy as jnp

from mppi_robotarm.config import ArmParams, MPPIConfig, SimConfig
from mppi_robotarm.sim.loop import (
    init_sim,
    init_sim_batch,
    sim_step,
    simulate,
    simulate_batch,
)
from mppi_robotarm.sim.pathgen import generate_circle_path, save_path_file
from mppi_robotarm.sim.paths import load_ref_path

ARM = ArmParams()


def test_generated_path_tracks_circle(tmp_path):
    """The PD+computed-torque pipeline reproduces the circle geometry and the
    reference's 6-col file format (SURVEY.md §3.5, C24)."""
    rows = np.asarray(generate_circle_path(ARM, num_steps=2000, dt=0.003))
    assert rows.shape == (2000, 6)
    # starts at the circle start point (1.4, 0.8) like xydq_circle.txt row 0
    np.testing.assert_allclose(rows[0, 0:2], [1.4, 0.8], atol=2e-2)
    # stays on the circle of radius 0.6 centred (0.8, 0.8)
    r = np.hypot(rows[:, 0] - 0.8, rows[:, 1] - 0.8)
    np.testing.assert_allclose(r, 0.6, atol=2e-2)
    # torques stay bounded and non-trivial (gravity compensation alone ~10 Nm)
    assert 1.0 < np.abs(rows[:, 4]).max() < 100.0

    # file-format round trip through the reference loader path
    f = os.path.join(tmp_path, "gen_circle.txt")
    save_path_file(f, rows)
    back = load_ref_path(f, dtype=np.float64)
    np.testing.assert_allclose(back, rows[:, 0:4], rtol=1e-12)


def test_generated_path_usable_by_mppi(tmp_path):
    """An MPPI controller can track a freshly generated path end to end."""
    rows = generate_circle_path(ARM, num_steps=1000, dt=0.003)
    ref = jnp.concatenate([rows[:, 0:4]], axis=1)
    cfg = MPPIConfig()
    sim = SimConfig()
    # start from the generated path's implied initial joint state: use the
    # default preset state (same circle start).
    s0 = init_sim(cfg, sim, jax.random.PRNGKey(0), dtype=jnp.float64)
    _, rec = simulate(ARM, cfg, sim, ref.astype(jnp.float64), s0, 30)
    ee = np.asarray(rec.ee)
    err = np.linalg.norm(ee - np.asarray(ref)[1:31, 0:2], axis=1)
    assert err.mean() < 2e-2, err.mean()


def test_simulate_batch_matches_single(ref_path):
    """Each scenario of the batched sim equals its standalone run."""
    cfg = MPPIConfig()
    import dataclasses
    cfg = dataclasses.replace(cfg, num_samples=32, horizon=8)
    sim = SimConfig()
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(3))
    ref = jnp.asarray(ref_path, jnp.float64)

    q0 = jnp.asarray([[1.1522, -1.2661]] * 3, jnp.float64) + \
        jnp.asarray([[0.0, 0.0], [0.01, -0.01], [-0.02, 0.03]], jnp.float64)
    states0 = init_sim_batch(cfg, sim, keys, q0=q0, dtype=jnp.float64)
    finals, recs = simulate_batch(ARM, cfg, sim, ref, states0, 5)

    for b in range(3):
        s0 = init_sim(cfg, sim, keys[b], dtype=jnp.float64)
        s0 = s0._replace(q=q0[b])
        fin, rec = simulate(ARM, cfg, sim, ref, s0, 5)
        np.testing.assert_allclose(np.asarray(recs.q[:, b]),
                                   np.asarray(rec.q), rtol=1e-9, atol=1e-12,
                                   err_msg=f"scenario {b}")
        np.testing.assert_allclose(np.asarray(recs.u[:, b]),
                                   np.asarray(rec.u), rtol=1e-9, atol=1e-12)
    # scenarios with different noise/initial states diverge
    assert not np.allclose(np.asarray(recs.q[:, 0]), np.asarray(recs.q[:, 1]))
