"""Golden value measured from the ACTUAL reference implementation.

Obtained by running /root/reference/control.py's
``MPPIControllerForPathTracking.calc_control_input`` under the run.py:25-37
config with ``np.random.seed(0)`` (global MT19937, quirk Q8) on the
run.py:14 initial state: the first-step control is

    u0 = [9.63530396, -3.48165726]

The same seeded noise tensor (``np.random.multivariate_normal(0, 20I,
(100, 30))`` as control.py:163 draws it) is injected into both the NumPy
oracle and the JAX solver; all three must agree.

Note: on the very first solve the uniform warm start makes the pre-shift
``u_new[0]`` and the post-shift applied control ``u_new[1]`` coincide for
this noise draw, so this single-step golden cannot distinguish the Q3
shift-before-return semantics — the multi-step closed-loop replay
(test_reference_replay.py, bitwise vs the executed reference) pins that.
"""

import numpy as np
import jax.numpy as jnp

from mppi_robotarm.config import ArmParams, MPPIConfig
from mppi_robotarm.mppi.solver import init_state, solve
from oracle import OracleMPPI

GOLDEN_U0 = np.array([9.63530396460894, -3.481657264286825])
X0 = np.array([1.152198236517471885, -1.266101672070702344, 0.0, 0.0])


def _seeded_reference_noise():
    rs = np.random.RandomState(0)          # the reference's global MT19937
    return rs.multivariate_normal(
        np.zeros(2), np.array([[20.0, 0.0], [0.0, 20.0]]), (100, 30))


def test_oracle_reproduces_reference_bitstream(ref_path):
    eps = _seeded_reference_noise()
    o = OracleMPPI(np.asarray(ref_path))
    u0, _, _, _ = o.solve(X0, eps)
    np.testing.assert_allclose(u0, GOLDEN_U0, rtol=1e-8)


def test_jax_solver_reproduces_reference_golden(ref_path):
    eps = _seeded_reference_noise()
    res = solve(ArmParams(), MPPIConfig(), jnp.asarray(ref_path),
                jnp.asarray(X0), init_state(MPPIConfig(), dtype=jnp.float64),
                eps=jnp.asarray(eps))
    np.testing.assert_allclose(np.asarray(res.u0), GOLDEN_U0, rtol=1e-8)


def test_jax_solver_f32_within_gate(ref_path):
    """float32 reproduces the reference golden within the 1e-3 gate."""
    eps = _seeded_reference_noise()
    res = solve(ArmParams(), MPPIConfig(), jnp.asarray(ref_path, jnp.float32),
                jnp.asarray(X0, jnp.float32), init_state(MPPIConfig()),
                eps=jnp.asarray(eps, jnp.float32))
    np.testing.assert_allclose(np.asarray(res.u0), GOLDEN_U0, atol=1e-3)
