"""Tests for aux subsystems: checkpoint/resume, metrics, plotting, CLI."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp

from mppi_robotarm.config import ArmParams, MPPIConfig, SimConfig
from mppi_robotarm.sim.loop import init_sim, simulate
from mppi_robotarm.utils.checkpoint import load_checkpoint, save_checkpoint
from mppi_robotarm.utils.metrics import (
    MetricsLogger,
    nan_guard,
    solve_metrics,
    tracking_errors,
)

ARM = ArmParams()
CFG = MPPIConfig()
SIM = SimConfig()


def test_checkpoint_resume_bitwise(ref_path, tmp_path):
    """Save at step 5, resume, and reproduce the uninterrupted run exactly
    (SURVEY.md §5.4)."""
    ref = jnp.asarray(ref_path)
    s0 = init_sim(CFG, SIM, jax.random.PRNGKey(9), dtype=jnp.float64)
    # uninterrupted 10 steps
    s_full, rec_full = simulate(ARM, CFG, SIM, ref, s0, 10)
    # interrupted: 5 steps -> checkpoint -> resume -> 5 more
    s_half, _ = simulate(ARM, CFG, SIM, ref, s0, 5)
    ckpt = os.path.join(tmp_path, "state.npz")
    save_checkpoint(ckpt, s_half)
    s_res = load_checkpoint(ckpt)
    assert int(s_res.step) == 5
    s_end, rec_tail = simulate(ARM, CFG, SIM, ref, s_res, 5)
    np.testing.assert_array_equal(np.asarray(s_end.q), np.asarray(s_full.q))
    np.testing.assert_array_equal(np.asarray(s_end.mppi.u_prev),
                                  np.asarray(s_full.mppi.u_prev))
    assert int(s_end.mppi.wp_idx) == int(s_full.mppi.wp_idx)
    np.testing.assert_array_equal(np.asarray(rec_tail.q[-1]),
                                  np.asarray(rec_full.q[-1]))


def test_checkpoint_missing_field(tmp_path):
    import pytest
    bad = os.path.join(tmp_path, "bad.npz")
    np.savez(bad, step=np.int32(0))
    with pytest.raises(ValueError, match="missing fields"):
        load_checkpoint(bad)


def test_metrics():
    w = jnp.asarray([0.5, 0.5, 0.0, 0.0])
    m = solve_metrics(jnp.asarray([1.0, 2.0, 3.0, 4.0]), w)
    assert m["cost_min"] == 1.0 and m["cost_max"] == 4.0
    np.testing.assert_allclose(m["ess"], 2.0)
    np.testing.assert_allclose(m["weight_entropy"], np.log(2.0))
    e = tracking_errors(np.zeros((5, 2)), np.ones((5, 2)))
    np.testing.assert_allclose(e["ee_rms_m"], np.sqrt(2.0))
    assert nan_guard(jnp.ones(3))
    assert not nan_guard(jnp.asarray([1.0, np.nan]))


def test_metrics_logger_cadence():
    import io
    buf = io.StringIO()
    lg = MetricsLogger(stream=buf, every=10)
    for i in range(25):
        lg.log(i, v=i)
    lines = [json.loads(l) for l in buf.getvalue().splitlines()]
    assert [l["step"] for l in lines] == [0, 10, 20]


def test_plotting_figures(ref_path):
    """Figures render headless from a real short run (run.py:120-173 parity)."""
    ref = jnp.asarray(ref_path)
    s0 = init_sim(CFG, SIM, jax.random.PRNGKey(0), dtype=jnp.float64)
    _, rec = simulate(ARM, CFG, SIM, ref, s0, 5)
    from mppi_robotarm.utils.plotting import (
        plot_arm_schematic, plot_results, plot_sampled_trajectories)
    fig1, fig2 = plot_results(rec, ref_path)
    assert len(fig1.axes) == 4 and len(fig2.axes) == 2
    fig3 = plot_arm_schematic()
    assert fig3.axes
    # sampled-trajectory render from real viz rollouts
    from mppi_robotarm.mppi.solver import init_state, solve, viz_rollouts
    st = init_state(CFG, dtype=jnp.float64)
    obs = jnp.asarray([1.1522, -1.2661, 0.0, 0.0], jnp.float64)
    res = solve(ARM, CFG, ref, obs, st, key=jax.random.PRNGKey(1))
    viz = viz_rollouts(ARM, CFG, obs, res.u_seq, st.u_prev, res.eps, res.costs)
    fig4 = plot_sampled_trajectories(obs[:2], viz.sampled_trajs,
                                     viz.optimal_traj, ref_path,
                                     viz.sorted_idx)
    assert fig4.axes
    import matplotlib.pyplot as plt
    plt.close("all")


def test_viz_rollout_q4_offbyone(ref_path):
    """Quirk Q4: the viz re-rollout applies u rolled by one (last-first)."""
    from mppi_robotarm.ops.rollout import rollout_trajectory
    from oracle import oracle_step
    u = np.arange(12, dtype=np.float64).reshape(6, 2)
    x0 = np.array([1.0, -1.0, 0.1, 0.2])
    traj = np.asarray(rollout_trajectory(ARM, CFG, jnp.asarray(x0),
                                         jnp.asarray(u)))
    # manual reference: x = F(x, u[t-1]) for t = 0..T-1
    x = x0.copy()
    for t in range(6):
        x = oracle_step(x, u[t - 1], CFG.delta_t)
        np.testing.assert_allclose(traj[t], x, rtol=1e-12)


def test_cli_end_to_end(ref_path, tmp_path):
    """The CLI driver runs a short tracking sim, writes records + figures."""
    from mppi_robotarm.cli import main
    out = os.path.join(tmp_path, "out")
    ckpt = os.path.join(tmp_path, "ck.npz")
    rc = main(["--steps", "6", "--samples", "16", "--horizon", "8",
               "--out-dir", out, "--figures", "--checkpoint", ckpt,
               "--metrics-every", "2"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "record.npz"))
    assert os.path.exists(os.path.join(out, "figure1_tracking.png"))
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert summary["steps"] == 6 and summary["K"] == 16
    assert os.path.exists(ckpt)
    # resume path
    rc = main(["--steps", "4", "--samples", "16", "--horizon", "8",
               "--checkpoint", ckpt])
    assert rc == 0


def test_cli_checkpoint_every(tmp_path):
    from mppi_robotarm.cli import main
    ckpt = os.path.join(tmp_path, "p.npz")
    rc = main(["--steps", "9", "--samples", "8", "--horizon", "6",
               "--checkpoint", ckpt, "--checkpoint-every", "3"])
    assert rc == 0
    st = load_checkpoint(ckpt)
    assert int(st.step) == 9


def test_orbax_checkpoint_roundtrip(ref_path, tmp_path):
    """The orbax (multi-host) checkpoint backend round-trips a SimState
    bitwise, same as the .npz path (SURVEY.md §5.4)."""
    import pytest
    pytest.importorskip("orbax.checkpoint")
    from mppi_robotarm.utils.checkpoint import (load_checkpoint_orbax,
                                                    save_checkpoint_orbax)
    state = init_sim(CFG, SIM, jax.random.PRNGKey(3))
    path = str(tmp_path / "orbax_ckpt")
    save_checkpoint_orbax(path, state)
    restored = load_checkpoint_orbax(path)
    np.testing.assert_array_equal(np.asarray(restored.q),
                                  np.asarray(state.q))
    np.testing.assert_array_equal(np.asarray(restored.mppi.u_prev),
                                  np.asarray(state.mppi.u_prev))
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(restored.key)),
        np.asarray(jax.random.key_data(state.key)))
    assert int(restored.step) == int(state.step)


def test_plot_results_short_ref_path(ref_path):
    """A ref path shorter than the run must not crash the figures after the
    (expensive) simulation completed — the reference curves simply stop at
    the last available row (regression: unguarded ref[1:n+1] slice)."""
    ref = jnp.asarray(ref_path)
    s0 = init_sim(CFG, SIM, jax.random.PRNGKey(0), dtype=jnp.float64)
    _, rec = simulate(ARM, CFG, SIM, ref, s0, 8)
    from mppi_robotarm.utils.plotting import plot_results
    short = np.asarray(ref_path)[:5]          # 5 rows < 8 recorded steps
    fig1, fig2 = plot_results(rec, short)
    assert len(fig1.axes) == 4 and len(fig2.axes) == 2
    import matplotlib.pyplot as plt
    plt.close("all")
