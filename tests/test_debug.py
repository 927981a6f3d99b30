"""Debug/sanitizer subsystem tests (SURVEY.md §5.2)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mppi_robotarm.config import ArmParams, MPPIConfig
from mppi_robotarm.mppi.solver import MPPIState, init_state
from mppi_robotarm.utils.debug import checked_solve, debug_mode

ARM = ArmParams()
CFG = MPPIConfig()
X0 = np.array([1.152198236517471885, -1.266101672070702344, 0.0, 0.0])


def test_checked_solve_ok(ref_path, rng):
    eps = rng.normal(size=(CFG.num_samples, CFG.horizon, 2)) * np.sqrt(20.0)
    err, res = checked_solve(ARM, CFG, jnp.asarray(ref_path), jnp.asarray(X0),
                             init_state(CFG, dtype=jnp.float64),
                             eps=jnp.asarray(eps))
    err.throw()  # no error
    assert np.all(np.isfinite(np.asarray(res.u0)))


def test_checked_solve_path_end_raises(ref_path, rng):
    """The reference IndexError (Q6) surfaces as a checkify error under jit."""
    eps = rng.normal(size=(CFG.num_samples, CFG.horizon, 2)) * np.sqrt(20.0)
    n = ref_path.shape[0]
    state = MPPIState(u_prev=init_state(CFG, dtype=jnp.float64).u_prev,
                      wp_idx=jnp.asarray(n - 2, jnp.int32))
    # EE at the final waypoint so the frozen index advances to the end
    tx, ty = ref_path[n - 1, 0], ref_path[n - 1, 1]
    c2 = np.clip((tx * tx + ty * ty - 2.0) / 2.0, -1, 1)
    q2 = np.arccos(c2)
    q1 = np.arctan2(ty, tx) - np.arctan2(np.sin(q2), 1 + np.cos(q2))
    x = jnp.asarray([q1, q2, 0.0, 0.0])
    err, _ = checked_solve(ARM, CFG, jnp.asarray(ref_path), x, state,
                           eps=jnp.asarray(eps))
    with pytest.raises(Exception, match="end of the reference path"):
        err.throw()


def test_debug_mode_restores_flags():
    before = (jax.config.jax_debug_nans, jax.config.jax_enable_checks)
    with debug_mode():
        assert jax.config.jax_debug_nans
    assert (jax.config.jax_debug_nans, jax.config.jax_enable_checks) == before


def test_checked_solve_pallas_backend(ref_path, rng):
    """checked_solve passes its keywords through: the kernel backend is
    checked the same way (finite controls, no path end)."""
    cfg = dataclasses.replace(CFG, num_samples=256, horizon=4)
    eps = (rng.normal(size=(256, 4, 2)) * 4.0).astype(np.float32)
    err, res = checked_solve(ARM, cfg, jnp.asarray(ref_path, jnp.float32),
                             jnp.asarray(X0, jnp.float32),
                             init_state(cfg, dtype=jnp.float32),
                             eps=jnp.asarray(eps), backend="pallas")
    err.throw()
    assert np.all(np.isfinite(np.asarray(res.u0)))
    assert np.all(np.isfinite(np.asarray(res.costs)))


def test_fault_injection_checkpoint_recovery(ref_path, tmp_path):
    """Fault drill (SURVEY.md §5.3): NaN-poison the closed-loop state
    mid-run, detect it with nan_guard, restart from the last checkpoint, and
    finish bitwise-identically to an uninterrupted run."""
    import dataclasses
    import jax.numpy as jnp
    from mppi_robotarm.config import MPPIConfig, SimConfig
    from mppi_robotarm.sim.loop import init_sim, simulate
    from mppi_robotarm.utils.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from mppi_robotarm.utils.metrics import nan_guard

    cfg = dataclasses.replace(MPPIConfig(), num_samples=32, horizon=6)
    sim = SimConfig()
    ref = jnp.asarray(ref_path, jnp.float32)
    total, pre = 12, 5

    # uninterrupted run
    s0 = init_sim(cfg, sim, jax.random.PRNGKey(11))
    ref_final, _ = simulate(ARM, cfg, sim, ref, s0, total)

    # interrupted run: checkpoint at step `pre`, then a fault poisons q
    s0b = init_sim(cfg, sim, jax.random.PRNGKey(11))
    mid, _ = simulate(ARM, cfg, sim, ref, s0b, pre)
    ckpt = str(tmp_path / "drill.npz")
    save_checkpoint(ckpt, mid)
    poisoned = mid._replace(q=mid.q.at[0].set(jnp.nan))  # the injected fault
    bad_final, bad_rec = simulate(ARM, cfg, sim, ref, poisoned, total - pre)
    # detection: the NaN propagates and the guard flags it
    assert not nan_guard(bad_final.q), "fault must be detectable"
    assert not nan_guard(bad_rec.u)

    # recovery: reload the checkpoint and finish the run
    restored = load_checkpoint(ckpt)
    rec_final, _ = simulate(ARM, cfg, sim, ref, restored, total - pre)

    # bitwise identity with the uninterrupted run
    for field in ("q", "dq", "done"):
        np.testing.assert_array_equal(
            np.asarray(getattr(rec_final, field)),
            np.asarray(getattr(ref_final, field)), err_msg=field)
    np.testing.assert_array_equal(np.asarray(rec_final.mppi.u_prev),
                                  np.asarray(ref_final.mppi.u_prev))
    assert int(rec_final.mppi.wp_idx) == int(ref_final.mppi.wp_idx)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(rec_final.key)),
        np.asarray(jax.random.key_data(ref_final.key)))
