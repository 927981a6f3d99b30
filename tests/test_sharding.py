"""Sharded-solver tests on an 8-virtual-device CPU mesh (SURVEY.md §4.4).

Verifies that sharding the K sample axis (psum/pmin collectives) and the
scenario batch axis is numerically transparent: the sharded solve must equal
the single-device solve on the same inputs.
"""

import dataclasses
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mppi_robotarm.config import ArmParams, MPPIConfig
from mppi_robotarm.mppi.solver import MPPIState, solve
from mppi_robotarm.parallel.mesh import make_mesh
from mppi_robotarm.parallel.sharded import (
    make_sharded_sim_step,
    make_sharded_solve,
)

ARM = ArmParams()
X0 = np.array([1.152198236517471885, -1.266101672070702344, 0.0, 0.0])

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _eight_devices():
    """conftest.py gives 8 virtual CPU devices; decided here, at run time."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual CPU devices")


def _batch_inputs(cfg, batch, rng, dtype):
    obs = np.tile(X0, (batch, 1)) + rng.normal(scale=0.01, size=(batch, 4))
    u_prev = np.tile(np.asarray(cfg.warm_start), (batch, cfg.horizon, 1))
    wp_idx = np.zeros((batch,), np.int32)
    eps = rng.normal(size=(batch, cfg.num_samples, cfg.horizon, 2)) * np.sqrt(20.0)
    return (jnp.asarray(obs, dtype), jnp.asarray(u_prev, dtype),
            jnp.asarray(wp_idx), jnp.asarray(eps, dtype))


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_solve_matches_single_chip(ref_path, rng, mesh_shape):
    data_ax, samples_ax = mesh_shape
    mesh = make_mesh(data=data_ax, samples=samples_ax)
    cfg = dataclasses.replace(MPPIConfig(), num_samples=64, horizon=12)
    batch = 2 * data_ax
    obs, u_prev, wp_idx, eps = _batch_inputs(cfg, batch, rng, jnp.float64)
    ref = jnp.asarray(ref_path)

    sharded = make_sharded_solve(ARM, cfg, mesh)
    u0_s, useq_s, unext_s, wp_s, end_s, s_s, w_s = sharded(
        ref, obs, u_prev, wp_idx, eps)

    for b in range(batch):
        res = solve(ARM, cfg, ref, obs[b],
                    MPPIState(u_prev=u_prev[b], wp_idx=wp_idx[b]),
                    eps=eps[b])
        np.testing.assert_allclose(np.asarray(u0_s[b]), np.asarray(res.u0),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(useq_s[b]),
                                   np.asarray(res.u_seq), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(s_s[b]), np.asarray(res.costs),
                                   rtol=1e-9)
        np.testing.assert_allclose(np.asarray(w_s[b]), np.asarray(res.weights),
                                   rtol=1e-8, atol=1e-12)
        assert int(wp_s[b]) == int(res.state.wp_idx)


def test_exploration_split_respects_global_index(ref_path, rng):
    """Q9 under sample sharding: the exploitation cutoff is a *global* sample
    index, so shard-local offsets must be applied."""
    mesh = make_mesh(data=1, samples=8)
    cfg = dataclasses.replace(MPPIConfig(), num_samples=64, horizon=8,
                              exploration=0.25)
    obs, u_prev, wp_idx, eps = _batch_inputs(cfg, 1, rng, jnp.float64)
    ref = jnp.asarray(ref_path)
    sharded = make_sharded_solve(ARM, cfg, mesh)
    u0_s, _, _, _, _, s_s, _ = sharded(ref, obs, u_prev, wp_idx, eps)
    res = solve(ARM, cfg, ref, obs[0],
                MPPIState(u_prev=u_prev[0], wp_idx=wp_idx[0]), eps=eps[0])
    np.testing.assert_allclose(np.asarray(s_s[0]), np.asarray(res.costs),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(u0_s[0]), np.asarray(res.u0),
                               rtol=1e-9, atol=1e-9)


def test_sharded_sim_step_runs_and_is_finite(ref_path):
    """The full sharded closed-loop step (on-device noise) executes and stays
    finite on a 4x2 mesh."""
    mesh = make_mesh(data=4, samples=2)
    cfg = dataclasses.replace(MPPIConfig(), num_samples=16, horizon=6)
    from mppi_robotarm.config import SimConfig
    sim = SimConfig()
    step_fn = make_sharded_sim_step(ARM, cfg, sim, mesh)
    batch = 8
    q = jnp.tile(jnp.asarray([X0[:2]], jnp.float32), (batch, 1))
    dq = jnp.zeros((batch, 2), jnp.float32)
    u_prev = jnp.tile(jnp.asarray(cfg.warm_start, jnp.float32),
                      (batch, cfg.horizon, 1))
    wp_idx = jnp.zeros((batch,), jnp.int32)
    keys = jax.random.key_data(
        jax.vmap(jax.random.PRNGKey)(jnp.arange(batch))).astype(jnp.uint32)
    q2, dq2, up2, wp2, done, u0 = step_fn(jnp.asarray(ref_path, jnp.float32),
                                          q, dq, u_prev, wp_idx, keys)
    assert np.all(np.isfinite(np.asarray(q2)))
    assert np.all(~np.asarray(done))
    # different scenarios draw different noise -> different controls
    assert not np.allclose(np.asarray(u0[0]), np.asarray(u0[1]))


def test_dryrun_multichip_entrypoint():
    """The CPU-mesh dry run compiles and executes on 8 CPU devices."""
    sys.path.insert(0, _REPO)
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_entry_compiles():
    sys.path.insert(0, _REPO)
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.all(np.isfinite(np.asarray(out[0])))


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8), (4, 2)])
def test_sharded_pallas_matches_single_chip(ref_path, rng, mesh_shape):
    """The rollout kernel per shard + the three collectives over 'samples'
    == the single-device XLA solve (f32)."""
    data_ax, samples_ax = mesh_shape
    mesh = make_mesh(data=data_ax, samples=samples_ax)
    cfg = dataclasses.replace(MPPIConfig(), num_samples=64 * samples_ax,
                              horizon=6, exploration=0.25)
    batch = data_ax
    obs, u_prev, wp_idx, eps = _batch_inputs(cfg, batch, rng, jnp.float32)
    ref = jnp.asarray(ref_path, jnp.float32)

    sharded = make_sharded_solve(ARM, cfg, mesh, backend="pallas")
    u0_s, useq_s, unext_s, wp_s, end_s, s_s, w_s = sharded(
        ref, obs, u_prev, wp_idx, eps)

    for b in range(batch):
        res = solve(ARM, cfg, ref, obs[b],
                    MPPIState(u_prev=u_prev[b], wp_idx=wp_idx[b]),
                    eps=eps[b])
        np.testing.assert_allclose(np.asarray(s_s[b]), np.asarray(res.costs),
                                   rtol=3e-5)
        np.testing.assert_allclose(np.asarray(u0_s[b]), np.asarray(res.u0),
                                   rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(np.asarray(w_s[b]),
                                   np.asarray(res.weights), rtol=1e-3,
                                   atol=1e-6)
        assert int(wp_s[b]) == int(res.state.wp_idx)


def test_non_divisible_k_raises(ref_path):
    """K not divisible by the 'samples' axis must raise, not silently drop
    samples (round-1 W3)."""
    import dataclasses as dc
    from mppi_robotarm.config import MPPIConfig, SimConfig
    from mppi_robotarm.parallel.mesh import make_mesh
    from mppi_robotarm.parallel.sharded import (
        make_sharded_sim_step, make_sharded_solve)
    mesh = make_mesh(data=1, samples=8)
    bad = dc.replace(MPPIConfig(), num_samples=100)  # 100 % 8 != 0
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_solve(ARM, bad, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_sim_step(ARM, bad, SimConfig(), mesh)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_sim_step_outputs_span_the_mesh(ref_path, backend):
    """Every output is laid out over all 8 devices along 'data' — nothing
    silently gathers onto device 0."""
    from mppi_robotarm.config import SimConfig
    mesh = make_mesh(data=8, samples=1)
    cfg = dataclasses.replace(MPPIConfig(), num_samples=16, horizon=4)
    step_fn = make_sharded_sim_step(ARM, cfg, SimConfig(), mesh,
                                    backend=backend)
    batch = 16
    q = jnp.tile(jnp.asarray([X0[:2]], jnp.float32), (batch, 1))
    u_prev = jnp.tile(jnp.asarray(cfg.warm_start, jnp.float32),
                      (batch, cfg.horizon, 1))
    keys = jax.random.key_data(
        jax.vmap(jax.random.PRNGKey)(jnp.arange(batch))).astype(jnp.uint32)
    outs = step_fn(jnp.asarray(ref_path, jnp.float32), q,
                   jnp.zeros((batch, 2), jnp.float32), u_prev,
                   jnp.zeros((batch,), jnp.int32), keys)
    for o in outs:
        assert len(o.sharding.device_set) == 8
        assert len(o.addressable_shards) == 8


def test_unknown_sharded_backend_raises():
    from mppi_robotarm.config import SimConfig
    mesh = make_mesh(data=8, samples=1)
    cfg = dataclasses.replace(MPPIConfig(), num_samples=16, horizon=4)
    with pytest.raises(ValueError, match="unknown backend"):
        make_sharded_solve(ARM, cfg, mesh, backend="pallas-fused")
    with pytest.raises(ValueError, match="unknown backend"):
        make_sharded_sim_step(ARM, cfg, SimConfig(), mesh, backend="mosaic")


def test_sharded_sim_step_pallas_matches_xla(ref_path):
    """The sharded closed-loop step with the rollout kernel per shard
    (backend='pallas') tracks the XLA path step-for-step over 5 steps on a
    2x4 mesh."""
    from mppi_robotarm.config import SimConfig
    mesh = make_mesh(data=2, samples=4)
    cfg = dataclasses.replace(MPPIConfig(), num_samples=32, horizon=6)
    sim = SimConfig()
    f_xla = make_sharded_sim_step(ARM, cfg, sim, mesh)
    f_pal = make_sharded_sim_step(ARM, cfg, sim, mesh, backend="pallas")
    batch = 4
    ref = jnp.asarray(ref_path, jnp.float32)
    q = jnp.tile(jnp.asarray([X0[:2]], jnp.float32), (batch, 1))
    dq = jnp.zeros((batch, 2), jnp.float32)
    up = jnp.tile(jnp.asarray(cfg.warm_start, jnp.float32),
                  (batch, cfg.horizon, 1))
    wp = jnp.zeros((batch,), jnp.int32)
    sa = (q, dq, up, wp)
    sb = (q, dq, up, wp)
    key = jax.random.PRNGKey(3)
    for i in range(5):
        key, sub = jax.random.split(key)
        keys = jax.random.key_data(
            jax.vmap(lambda s: jax.random.fold_in(sub, s))(
                jnp.arange(batch))).astype(jnp.uint32)
        qa, dqa, upa, wpa, da, u0a = f_xla(ref, *sa, keys)
        qb, dqb, upb, wpb, db, u0b = f_pal(ref, *sb, keys)
        # identical threefry noise; kernel vs XLA differ only in summation
        # order — tolerance grows with the mildly chaotic loop
        tol = 1e-5 * 4 ** i
        np.testing.assert_allclose(np.asarray(qb), np.asarray(qa), atol=tol,
                                   err_msg=f"q step {i}")
        np.testing.assert_allclose(np.asarray(u0b), np.asarray(u0a),
                                   atol=10 * tol, err_msg=f"u0 step {i}")
        np.testing.assert_array_equal(np.asarray(wpb), np.asarray(wpa))
        assert not np.any(np.asarray(da)) and not np.any(np.asarray(db))
        sa = (qa, dqa, upa, wpa)
        sb = (qb, dqb, upb, wpb)


def test_initialize_multihost_single_process_noop():
    """On a single-process run the multihost bring-up must be a harmless
    no-op (the pod path auto-detects from the environment)."""
    from mppi_robotarm.parallel.mesh import initialize_multihost
    initialize_multihost()          # must not raise
    initialize_multihost()          # idempotent


def test_detect_multihost_env():
    """The pod branch's env-var parsing, exercised with mocked environments
    (round-2 W6 — no cluster needed to logic-test the bring-up)."""
    from mppi_robotarm.parallel.mesh import detect_multihost_env

    # nothing set -> all None (single-process default)
    assert detect_multihost_env({}) == (None, None, None)

    # full JAX_* trio
    assert detect_multihost_env({
        "JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234",
        "JAX_NUM_PROCESSES": "4",
        "JAX_PROCESS_ID": "2",
    }) == ("10.0.0.1:1234", 4, 2)

    # MPPI_* aliases take precedence over JAX_*
    assert detect_multihost_env({
        "MPPI_COORDINATOR_ADDRESS": "h0:99",
        "JAX_COORDINATOR_ADDRESS": "other:1",
        "MPPI_NUM_PROCESSES": "2",
        "JAX_NUM_PROCESSES": "8",
        "MPPI_PROCESS_ID": "1",
        "JAX_PROCESS_ID": "7",
    }) == ("h0:99", 2, 1)

    # coordinator alone is fine (cluster plugin fills the rest)
    assert detect_multihost_env(
        {"JAX_COORDINATOR_ADDRESS": "h0:99"}) == ("h0:99", None, None)

    # malformed integers must raise, naming the variable
    with pytest.raises(ValueError, match="JAX_PROCESS_ID"):
        detect_multihost_env({"JAX_PROCESS_ID": "two"})

    # coordinator + only one of nproc/pid is an inconsistent launch
    with pytest.raises(ValueError, match="incomplete multihost"):
        detect_multihost_env({
            "JAX_COORDINATOR_ADDRESS": "h0:99",
            "JAX_NUM_PROCESSES": "4",
        })
