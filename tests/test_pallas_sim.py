"""The closed loop with the Pallas rollout kernel (``backend='pallas'``) —
``simulate`` / ``simulate_batch`` against the XLA backend on the same keys
(interpret mode on CPU)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

import mppi_robotarm as m
from mppi_robotarm.config import ArmParams, MPPIConfig, SimConfig

ARM = ArmParams()
SIM = SimConfig()
F32 = jnp.float32


def _run(cfg, ref, steps, backend, key=0, state=None):
    s0 = state if state is not None else m.init_sim(
        cfg, SIM, jax.random.PRNGKey(key), dtype=F32)
    return m.simulate(ARM, cfg, SIM, ref, s0, steps, backend=backend)


def test_pallas_loop_matches_xla_per_step(ref_path):
    """Same keys, same noise: the two backends differ only in float32
    summation order, amplified by the mildly chaotic loop (tolerance grows
    with the step, as in test_sim.py's long-parity notes)."""
    cfg = dataclasses.replace(MPPIConfig(), num_samples=128, horizon=8)
    ref = jnp.asarray(ref_path[:400], F32)
    steps = 6
    _, ra = _run(cfg, ref, steps, "xla")
    _, rb = _run(cfg, ref, steps, "pallas")
    for i in range(steps):
        np.testing.assert_allclose(np.asarray(rb.q[i]), np.asarray(ra.q[i]),
                                   atol=2e-6 * 4 ** i, err_msg=f"q step {i}")
        np.testing.assert_allclose(np.asarray(rb.u[i]), np.asarray(ra.u[i]),
                                   atol=2e-5 * 4 ** i, err_msg=f"u step {i}")
    np.testing.assert_array_equal(np.asarray(rb.wp_idx),
                                  np.asarray(ra.wp_idx))
    assert not np.any(np.asarray(rb.done))


def test_pallas_loop_k_padding(ref_path):
    """K=100 (the reference config) pads to the block inside the loop."""
    cfg = dataclasses.replace(MPPIConfig(), num_samples=100, horizon=6)
    ref = jnp.asarray(ref_path[:400], F32)
    _, ra = _run(cfg, ref, 4, "xla")
    _, rb = _run(cfg, ref, 4, "pallas")
    for i in range(4):
        np.testing.assert_allclose(np.asarray(rb.q[i]), np.asarray(ra.q[i]),
                                   atol=2e-6 * 4 ** i, err_msg=f"q step {i}")


def _short_path():
    # 40 waypoints over a tiny arc (~1.9 mm spacing) so the tracker
    # reaches the path end within the run
    return jnp.asarray(m.synth_circle_path(40, revolutions=0.02), F32)


def test_pallas_loop_path_end_freeze():
    """A short path trips the Q6 freeze; records stay done afterwards."""
    cfg = dataclasses.replace(MPPIConfig(), num_samples=128, horizon=6)
    final, rec = _run(cfg, _short_path(), 200, "pallas")
    done = np.asarray(rec.done)
    assert done[-1], "should have frozen at path end"
    first = int(np.argmax(done))
    assert np.all(done[first:])
    assert bool(final.done)


def test_pallas_loop_frozen_records_carry_state():
    """After path end the records keep the frozen q/dq and wp_idx, with the
    u and cost lanes zeroed."""
    cfg = dataclasses.replace(MPPIConfig(), num_samples=128, horizon=6)
    _, rec = _run(cfg, _short_path(), 200, "pallas")
    done = np.asarray(rec.done)
    first = int(np.argmax(done))
    q, dq = np.asarray(rec.q)[first:], np.asarray(rec.dq)[first:]
    assert np.all(q == q[0]) and np.all(dq == dq[0])
    assert np.any(q[0] != 0.0)
    assert np.all(np.asarray(rec.wp_idx)[first:] == int(rec.wp_idx[first]))
    assert np.all(np.asarray(rec.u)[first:] == 0.0)
    assert np.all(np.asarray(rec.cost_min)[first:] == 0.0)
    assert np.all(np.asarray(rec.cost_mean)[first:] == 0.0)


def test_pallas_loop_chunked_continues_full(ref_path):
    """Chaining simulate from the returned state equals one long run:
    records concatenate exactly and ref_xy rows stay step-aligned."""
    cfg = dataclasses.replace(MPPIConfig(), num_samples=128, horizon=8)
    ref = jnp.asarray(ref_path[:400], F32)
    _, rec_full = _run(cfg, ref, 6, "pallas", key=3)
    state = m.init_sim(cfg, SIM, jax.random.PRNGKey(3), dtype=F32)
    parts = []
    for n in (3, 3):
        state, rec = _run(cfg, ref, n, "pallas", state=state)
        parts.append(rec)
    assert int(state.step) == 6
    rec_chunk = jax.tree.map(lambda *xs: jnp.concatenate(xs, 0), *parts)
    for f in rec_full._fields:
        np.testing.assert_array_equal(np.asarray(getattr(rec_chunk, f)),
                                      np.asarray(getattr(rec_full, f)),
                                      err_msg=f)


def test_pallas_batch_matches_single(ref_path):
    """simulate_batch (the batch as a grid axis of the kernel) equals the
    single-scenario simulate per scenario."""
    cfg = dataclasses.replace(MPPIConfig(), num_samples=100, horizon=6)
    ref = jnp.asarray(ref_path[:400], F32)
    b, steps = 3, 4
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b))
    q0 = (jnp.tile(jnp.asarray([SIM.q0], F32), (b, 1))
          + 0.01 * jnp.arange(b, dtype=F32)[:, None])
    states = m.init_sim_batch(cfg, SIM, keys, q0=q0, dtype=F32)
    final, recb = m.simulate_batch(ARM, cfg, SIM, ref, states, steps,
                                   backend="pallas")
    assert recb.q.shape == (steps, b, 2) and recb.ess.shape == (steps, b)
    for i in range(b):
        si = jax.tree.map(lambda x: x[i], states)
        fi, ri = m.simulate(ARM, cfg, SIM, ref, si, steps, backend="pallas")
        np.testing.assert_allclose(np.asarray(recb.q[:, i]),
                                   np.asarray(ri.q), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(recb.wp_idx[:, i]),
                                      np.asarray(ri.wp_idx))
        assert int(final.mppi.wp_idx[i]) == int(fi.mppi.wp_idx)


def test_pallas_batch_matches_xla_batch(ref_path):
    """simulate_batch: pallas vs xla on the same keys."""
    cfg = dataclasses.replace(MPPIConfig(), num_samples=64, horizon=6)
    ref = jnp.asarray(ref_path[:400], F32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(4))
    states = m.init_sim_batch(cfg, SIM, keys, dtype=F32)
    _, ra = m.simulate_batch(ARM, cfg, SIM, ref, states, 3, backend="xla")
    _, rb = m.simulate_batch(ARM, cfg, SIM, ref, states, 3, backend="pallas")
    np.testing.assert_allclose(np.asarray(rb.q), np.asarray(ra.q), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(rb.wp_idx),
                                  np.asarray(ra.wp_idx))
