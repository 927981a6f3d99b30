"""Drop-in compatibility layer exposing the reference repo's exact API.

A user of junofficial/mppi_RobotArm can switch to this framework by changing
imports only::

    # from control import MPPIControllerForPathTracking
    # from utils import Arm_Dynamic, Forward_Kinemetic, ...
    # from sys_params import SYS_PARAMS
    from mppi_robotarm.compat import (
        MPPIControllerForPathTracking, Arm_Dynamic, Forward_Kinemetic,
        Inverse_Kinemetic, Feedback_linearization, Controller, SYS_PARAMS)

Every public symbol of the reference's ``control.py`` / ``utils.py`` /
``sys_params.py`` is reproduced with the same signature, defaults, return
structure, NumPy-in/NumPy-out convention, and side effects (mutable
``u_prev`` / ``prev_waypoints_idx`` attributes, the path-end ``IndexError``,
control.py:76-78) — but the K×T rollout sweep runs through the framework's
batched solver (``mppi.solver.solve``), so it runs as one compiled XLA
program instead of the reference's Python triple loop (control.py:91-109).

Numerics: the applied-control semantics are the reference's net behaviour
(quirk Q3 — the in-place warm-start shift precedes ``return u[0]`` on the
aliased array, control.py:148-152, so the applied control is the *shifted*
first element), parity-tested against the float64 oracle in
tests/test_compat.py.

Noise: by default this layer draws noise on the host with
``np.random.multivariate_normal`` from the *global* NumPy RNG — byte-for-byte
the reference's sampling path including quirk Q8 (unseeded global RNG;
``np.random.seed`` affects it exactly as it does the reference).  Pass
``rng=np.random.default_rng(s)`` for an isolated stream, or use the
framework-native API (``mppi_robotarm.solve``) for on-device PRNG.

The small per-call kinematics helpers (``Arm_Dynamic`` etc.) are pinned to
the CPU backend: they are scalar helpers called from host loops, each on a
few floats, and NumPy callers want NumPy back; a round trip to an
accelerator per call (launch, copy in, copy out) would cost more than the
arithmetic and buy nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .config import ArmParams, MPPIConfig
from .models import arm as _arm
from .mppi.solver import MPPIState, solve, viz_rollouts

__all__ = [
    "SYS_PARAMS",
    "Arm_Dynamic",
    "Forward_Kinemetic",
    "Inverse_Kinemetic",
    "Feedback_linearization",
    "Controller",
    "MPPIControllerForPathTracking",
]

_PARAMS = ArmParams()


def _cpu_device():
    return jax.devices("cpu")[0]


def SYS_PARAMS() -> dict:
    """Physical-constant dict, identical to the reference sys_params.py:1-13."""
    p = dataclasses.asdict(_PARAMS)
    # the reference dict uses ints for the unit masses/lengths; values equal
    return {
        "Ts": p["Ts"], "m1": p["m1"], "m2": p["m2"], "l1": p["l1"],
        "l2": p["l2"], "lc1": p["lc1"], "lc2": p["lc2"], "g": p["g"],
    }


def Arm_Dynamic(q, dq, u):
    """Plant continuous dynamics ``ddq = M⁻¹(u − C·dq − G)`` (utils.py:14-29).

    NumPy-in/NumPy-out wrapper over :func:`models.arm.arm_ddq` (analytic 2×2
    inverse, quirk Q1 inertia).  Accepts scalars-in-arrays shaped like the
    reference call sites (q, dq, u each length-2).
    """
    q = np.asarray(q, dtype=np.float64).reshape(-1)
    dq = np.asarray(dq, dtype=np.float64).reshape(-1)
    u = np.asarray(u, dtype=np.float64).reshape(-1)
    with jax.default_device(_cpu_device()):
        dd1, dd2 = _arm.arm_ddq(q[0], q[1], dq[0], dq[1], u[0], u[1], _PARAMS)
        return np.array([float(dd1), float(dd2)])


def Forward_Kinemetic(q):
    """FK of the 2-link arm → (x1, y1, x2, y2) (utils.py:32-38)."""
    q = np.asarray(q, dtype=np.float64).reshape(-1)
    with jax.default_device(_cpu_device()):
        x1, y1, x2, y2 = _arm.fk_full(q[0], q[1], _PARAMS)
        return float(x1), float(y1), float(x2), float(y2)


def Inverse_Kinemetic(Theta):
    """Circle-path IK → (r, XE, YE) (utils.py:41-62).

    ``r = [x1d, x2d − x1d]`` joint targets; includes the reference's two
    piecewise overrides near θ≈2π (utils.py:47-52).
    """
    with jax.default_device(_cpu_device()):
        r, xe, ye = _arm.ik_circle(float(Theta))
        return np.asarray(r, dtype=np.float64), float(xe), float(ye)


def Feedback_linearization(q, dq, v):
    """Computed-torque law ``u = M·v + C·dq + G`` (utils.py:65-84)."""
    q = np.asarray(q, dtype=np.float64).reshape(-1)
    dq = np.asarray(dq, dtype=np.float64).reshape(-1)
    v = np.asarray(v, dtype=np.float64).reshape(-1)
    with jax.default_device(_cpu_device()):
        u1, u2 = _arm.feedback_linearization(q[0], q[1], dq[0], dq[1],
                                             v[0], v[1], _PARAMS)
        return np.array([float(u1), float(u2)])


def Controller(q, dq, r, dr, ddr):
    """Outer-loop PD law ``v = ddr − KD(dq−dr) − KP(q−r)``, KD=20, KP=100
    (utils.py:87-93)."""
    with jax.default_device(_cpu_device()):
        v = _arm.pd_outer_loop(jnp.asarray(np.asarray(q, dtype=np.float64)),
                               jnp.asarray(np.asarray(dq, dtype=np.float64)),
                               jnp.asarray(np.asarray(r, dtype=np.float64)),
                               jnp.asarray(np.asarray(dr, dtype=np.float64)),
                               jnp.asarray(np.asarray(ddr,
                                                      dtype=np.float64)))
        return np.asarray(v, dtype=np.float64)


class MPPIControllerForPathTracking:
    """Reference-signature MPPI controller backed by the framework's solver.

    Constructor signature, defaults, public attributes (``u_prev``,
    ``prev_waypoints_idx``, ``param_gamma``, …) and the
    ``calc_control_input(observed_x) -> (u0, u_seq, optimal_traj,
    sampled_traj_list)`` return structure mirror control.py:21-152.

    Extra keyword-only knobs (framework-side, all optional):

    * ``backend`` — 'xla' (default, any dtype) or 'pallas' (the GPU
      rollout kernel, float32).
    * ``rng`` — a ``np.random.Generator`` for isolated noise; default
      ``None`` draws from the global ``np.random`` exactly like the
      reference (quirk Q8 — ``np.random.seed`` reproduces reference runs).
    * ``search_idx_len`` / ``filter_window`` — the reference's hardcoded 30
      (control.py:203) and 10 (control.py:122), surfaced as knobs.
    """

    def __init__(
        self,
        delta_t: float = 0.01,
        ref_path=0,
        horizon_step_T: int = 20,
        number_of_samples_K: int = 500,
        param_exploration: float = 0.0,
        param_lambda: float = 50.0,
        param_alpha: float = 1.0,
        sigma=np.array([[10.0, 10.0], [100.0, 100.0]]),
        stage_cost_weight=np.array([10.0, 10.0, 10.0, 10.0]),
        terminal_cost_weight=np.array([10.0, 10.0, 10.0, 10.0]),
        visualize_optimal_traj=True,
        visualze_sampled_trajs=False,
        *,
        backend: str = "xla",
        rng: Optional[np.random.Generator] = None,
        search_idx_len: int = 30,
        filter_window: int = 10,
    ) -> None:
        # -- the reference's Σ validation (control.py:157-159) --------------
        sigma = np.asarray(sigma, dtype=np.float64)
        self.dim_x = 4
        self.dim_u = 2
        if sigma.shape != (self.dim_u, self.dim_u):
            raise ValueError(
                "sigma must be a square matrix with the size of dim_u.")

        self.T = int(horizon_step_T)
        self.K = int(number_of_samples_K)
        self.param_exploration = float(param_exploration)
        self.param_lambda = float(param_lambda)
        self.param_alpha = float(param_alpha)
        self.param_gamma = self.param_lambda * (1.0 - self.param_alpha)
        self.Sigma = sigma
        self.stage_cost_weight = np.asarray(stage_cost_weight, np.float64)
        self.terminal_cost_weight = np.asarray(terminal_cost_weight,
                                               np.float64)
        self.visualize_optimal_traj = visualize_optimal_traj
        self.visualze_sampled_trajs = visualze_sampled_trajs
        self.delta_t = float(delta_t)
        self.ref_path = np.asarray(ref_path, dtype=np.float64)
        self.l1 = 1
        self.l2 = 1

        # warm start (control.py:59) + frozen waypoint index (control.py:65)
        self.u_prev = np.array([[10.0, -2.0] for _ in range(self.T)])
        self.prev_waypoints_idx = 0

        self._backend = backend
        self._rng = rng
        self._arm = ArmParams()
        self._cfg = MPPIConfig(
            horizon=self.T,
            num_samples=self.K,
            exploration=self.param_exploration,
            lam=self.param_lambda,
            alpha=self.param_alpha,
            sigma=tuple(tuple(float(v) for v in row) for row in sigma),
            stage_cost_weight=tuple(float(v)
                                    for v in self.stage_cost_weight),
            terminal_cost_weight=tuple(float(v)
                                       for v in self.terminal_cost_weight),
            delta_t=self.delta_t,
            search_idx_len=int(search_idx_len),
            filter_window=int(filter_window),
        )
        self._ref_dev = jnp.asarray(self.ref_path)

    # -- noise (control.py:154-164; quirk Q8 global-RNG default) ------------
    def _calc_epsilon(self, sigma, size_sample, size_time_step, size_dim_u):
        """Reference-identical sampling: multivariate normal, (K, T, 2)."""
        sigma = np.asarray(sigma, dtype=np.float64)
        if (sigma.shape[0] != sigma.shape[1]
                or size_dim_u != sigma.shape[0]):
            raise ValueError(
                "sigma must be a square matrix with the size of dim_u.")
        mu = np.zeros(size_dim_u)
        src = self._rng if self._rng is not None else np.random
        return src.multivariate_normal(mu, sigma,
                                       (size_sample, size_time_step))

    def calc_control_input(self, observed_x) -> Tuple[np.ndarray, ...]:
        """One MPPI solve (control.py:67-152 semantics, compiled execution).

        Returns ``(u0, u_seq, optimal_traj, sampled_traj_list)`` — note that
        because the reference shifts the aliased ``u_prev`` in place before
        returning (control.py:148-152), both ``u0`` and the returned
        ``u_seq`` are the *shifted* sequence, while the viz re-rollouts use
        the pre-shift update (quirks Q3/Q4); replicated exactly.
        Raises ``IndexError`` at the path end (control.py:76-78).
        """
        obs = np.asarray(observed_x, dtype=np.float64).reshape(-1)
        eps = self._calc_epsilon(self.Sigma, self.K, self.T, self.dim_u)

        dtype = (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        u_prev_in = jnp.asarray(self.u_prev, dtype=dtype)
        state = MPPIState(u_prev=u_prev_in,
                          wp_idx=jnp.asarray(self.prev_waypoints_idx,
                                             jnp.int32))
        res = solve(self._arm, self._cfg, self._ref_dev,
                    jnp.asarray(obs, dtype=dtype), state,
                    eps=jnp.asarray(eps, dtype=dtype),
                    backend=self._backend)

        # the reference advances prev_waypoints_idx, then raises BEFORE
        # touching u_prev (control.py:75-78)
        self.prev_waypoints_idx = int(res.state.wp_idx)
        if bool(res.path_end):
            print("[ERROR] Reached the end of the reference path.")
            raise IndexError

        optimal_traj = np.zeros((self.T, self.dim_x))
        sampled_traj_list = np.zeros((self.K, self.T, self.dim_x))
        if self.visualize_optimal_traj or self.visualze_sampled_trajs:
            viz = viz_rollouts(self._arm, self._cfg, jnp.asarray(obs, dtype),
                               res.u_seq, u_prev_in, res.eps, res.costs)
            if self.visualize_optimal_traj:
                optimal_traj = np.asarray(viz.optimal_traj, dtype=np.float64)
            if self.visualze_sampled_trajs:
                sampled_traj_list = np.asarray(viz.sampled_trajs,
                                               dtype=np.float64)

        # warm-start shift (control.py:147-149); the returned sequence is the
        # shifted one (aliasing, Q3)
        self.u_prev = np.asarray(res.state.u_prev, dtype=np.float64)
        u0 = np.asarray(res.u0, dtype=np.float64)
        return u0, self.u_prev.copy(), optimal_traj, sampled_traj_list
