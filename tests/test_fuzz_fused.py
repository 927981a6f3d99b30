"""Differential property test: the closed loop through the Pallas rollout
kernel (``simulate_batch(backend='pallas')``) vs the python reference driver
across EDGE-shaped configs.

Gates: the wp_idx schedule must match EXACTLY step for step (discrete —
immune to float noise), q within a chaos-aware envelope, and the loop's Q6
freeze must fire whenever the python driver raises the reference-parity
IndexError (control.py:76-78).  Both drivers draw the same noise from the
same keys.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mppi_robotarm as m
from mppi_robotarm.config import ArmParams, MPPIConfig, SimConfig

ARM = ArmParams()
SIM = SimConfig()
F32 = jnp.float32

# (K, T, W, fw, n_ref, steps, B, wp0) — chosen to hit: minimal shapes, K
# padding, W larger than the remaining path, near-end freeze, batches
CASES = [
    (1, 1, 1, 1, 40, 3, 1, 0),
    (1, 2, 30, 2, 80, 3, 1, 66),          # W window overhangs the path end
    (7, 3, 30, 1, 80, 2, 4, 65),          # odd K, batch of 4
    (100, 2, 1, 3, 40, 3, 4, 6),          # reference K padded, W=1
    (100, 8, 5, 7, 40, 3, 2, 28),         # freezes mid-run (Q6)
    (128, 13, 33, 2, 400, 2, 2, 235),     # W > 30, deep horizon
    (33, 1, 2, 2, 400, 4, 4, 32),         # T=1: terminal == first state
]


@pytest.mark.parametrize("K,T,W,fw,nref,steps,B,wp0v", CASES)
def test_pallas_loop_matches_python_driver_edge_shapes(K, T, W, fw, nref,
                                                      steps, B, wp0v):
    cfg = dataclasses.replace(MPPIConfig(), num_samples=K, horizon=T,
                              search_idx_len=W, filter_window=fw)
    ref = jnp.asarray(np.asarray(m.synth_circle_path(nref)), F32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B))
    q0 = (jnp.tile(jnp.asarray([SIM.q0], F32), (B, 1))
          + 0.01 * jnp.arange(B, dtype=F32)[:, None])
    states = m.init_sim_batch(cfg, SIM, keys, q0=q0, dtype=F32)
    states = states._replace(mppi=states.mppi._replace(
        wp_idx=jnp.full((B,), wp0v, jnp.int32)))
    _, rec = m.simulate_batch(ARM, cfg, SIM, ref, states, steps,
                              backend="pallas")
    q, wp, done = (np.asarray(rec.q), np.asarray(rec.wp_idx),
                   np.asarray(rec.done))

    for b in range(B):
        s0 = jax.tree.map(lambda x: x[b], states)
        try:
            _, recs = m.simulate_python(ARM, cfg, SIM, ref, s0, steps)
        except IndexError:
            assert done[:, b].any(), (
                f"b={b}: python driver hit path end but the loop never "
                f"froze")
            continue
        for i, r in enumerate(recs):
            if done[i, b]:
                break
            np.testing.assert_allclose(q[i, b], r[0], atol=1e-4 * 4 ** i,
                                       err_msg=f"q step {i} b={b}")
            assert int(wp[i, b]) == int(r[3]), (
                f"wp step {i} b={b}: {wp[i, b]} vs {r[3]}")
