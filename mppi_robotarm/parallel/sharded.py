"""Sharded multi-scenario / sharded-sample MPPI via ``shard_map``.

Scale-out of the single-chip solver (mppi/solver.py) over a
('data', 'samples') mesh (parallel/mesh.py):

  * scenarios shard over 'data' — no communication;
  * the K sample axis shards over 'samples' — the softmax normalisation and
    the weighted-noise reduction (reference control.py:303-312, 115-118)
    become exactly three collectives per solve:
        ρ  = pmin(min S_local)
        η  = psum(Σ exp(−(S_local−ρ)/λ))
        Σwε = psum(Σ w_local·ε_local)
    Everything downstream of the psum (median filter, warm-start shift) is
    replicated cheaply on every sample shard (T×2 floats).

The exploration split (Q9) depends on the *global* sample index, so each
shard passes ``k_offset = axis_index('samples') · K_local`` into the rollout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import ArmParams, MPPIConfig, SimConfig
from ..models.arm import arm_ddq, fk_ee
from ..mppi.solver import shift_warm_start
from ..ops.filters import median_filter_reflect
from ..ops.noise import sample_epsilon, sigma_cholesky, sigma_inverse
from ..ops.pallas_rollout import rollout_costs_pallas
from ..ops.rollout import rollout_costs
from ..ops.waypoint import update_waypoint_index
from .mesh import DATA_AXIS, SAMPLES_AXIS


def _solve_local(arm: ArmParams, cfg: MPPIConfig, ref_path, observed_x,
                 u_prev, wp_idx, eps_local, backend: str = "xla"):
    """Per-device, per-scenario solve body (runs under shard_map + vmap).

    ``eps_local``: (K_local, T, 2) — this shard's slice of the sample axis.
    ``backend``: 'xla' (``rollout_costs``) or 'pallas' (the GPU rollout
    kernel, ops/pallas_rollout.py) computes the shard's costs S.
    """
    kloc = eps_local.shape[0]
    dtype = u_prev.dtype
    k_offset = lax.axis_index(SAMPLES_AXIS) * kloc

    x_obs, y_obs = fk_ee(observed_x[0], observed_x[1], cfg.l1, cfg.l2)
    wp_new, window, valid = update_waypoint_index(
        ref_path, wp_idx, x_obs, y_obs, cfg.search_idx_len, cfg.dist_scale)
    path_end = wp_new >= ref_path.shape[0] - 1

    sigma_inv = jnp.asarray(sigma_inverse(cfg.sigma), dtype=dtype)
    if backend == "pallas":
        s_local = rollout_costs_pallas(
            arm, cfg, observed_x, u_prev, eps_local, window, valid,
            sigma_inv, k_offset=k_offset).astype(dtype)
    else:
        s_local, _ = rollout_costs(
            arm, cfg, observed_x, u_prev, eps_local, window, valid,
            sigma_inv, k_offset=k_offset)
    # Three collectives over the 'samples' axis (SURVEY.md §5.8).
    rho = lax.pmin(jnp.min(s_local), SAMPLES_AXIS)
    e = jnp.exp(-(s_local - rho) / jnp.asarray(cfg.lam, dtype))
    eta = lax.psum(jnp.sum(e), SAMPLES_AXIS)
    w_local = e / eta
    # HIGHEST: a GPU may otherwise run a float32 contraction in TF32
    w_eps = lax.psum(jnp.einsum("k,ktu->tu", w_local, eps_local,
                                precision=lax.Precision.HIGHEST),
                     SAMPLES_AXIS)

    w_eps = median_filter_reflect(w_eps, cfg.filter_window)
    u_seq = u_prev + w_eps
    # the reference applies the SHIFTED first element (control.py:148-152)
    u_next = shift_warm_start(u_seq)
    return u_next[0], u_seq, u_next, wp_new, path_end, s_local, w_local


def _check_backend(backend: str) -> None:
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")


def _check_samples_divisible(cfg: MPPIConfig, mesh: Mesh) -> None:
    """K must divide evenly over the 'samples' axis — a silent floor-division
    would drop samples and change the solver's semantics (round-1 W3)."""
    n = mesh.shape[SAMPLES_AXIS]
    if cfg.num_samples % n:
        raise ValueError(
            f"num_samples={cfg.num_samples} is not divisible by the "
            f"'{SAMPLES_AXIS}' mesh axis size {n}; choose K as a multiple "
            f"of the samples-axis size (dropped samples would silently "
            f"change the softmax/weighted-noise semantics)")


def make_sharded_solve(arm: ArmParams, cfg: MPPIConfig, mesh: Mesh,
                       backend: str = "xla"):
    """Build a jitted sharded solve over a batch of scenarios.

    Signature of the returned function:
        f(ref_path (N,4) replicated,
          observed  (B,4), u_prev (B,T,2), wp_idx (B,)  — sharded over 'data',
          eps       (B,K,T,2)               — sharded over ('data','samples'))
        -> (u0 (B,2), u_seq (B,T,2), u_prev_next (B,T,2), wp_idx (B,),
            path_end (B,), S (B,K), w (B,K))

    B must divide by the 'data' axis size and K by the 'samples' axis size.
    ``backend`` picks how each shard computes its costs (see
    :func:`_solve_local`); the three collectives are the same for both.
    """
    _check_samples_divisible(cfg, mesh)
    _check_backend(backend)

    def _per_device(ref_path, observed, u_prev, wp_idx, eps):
        return jax.vmap(
            lambda o, u, w, e: _solve_local(
                arm, cfg, ref_path, o, u, w, e, backend=backend)
        )(observed, u_prev, wp_idx, eps)

    fn = shard_map(
        _per_device,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                  P(DATA_AXIS, SAMPLES_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                   P(DATA_AXIS), P(DATA_AXIS, SAMPLES_AXIS),
                   P(DATA_AXIS, SAMPLES_AXIS)),
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_sim_step(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
                          mesh: Mesh, backend: str = "xla"):
    """One sharded closed-loop step over B scenarios: solve + plant + freeze.

    Scenarios shard over 'data', samples over 'samples'; each scenario's
    noise is drawn on device from its key with the sample-shard index
    folded in.  Returns a jitted function
        f(ref_path, q (B,2), dq (B,2), u_prev (B,T,2), wp_idx (B,),
          keys (B,2) uint32) -> (q', dq', u_prev', wp_idx', done (B,), u0 (B,2))

    ``backend`` picks how each shard computes its costs (see
    :func:`_solve_local`); both draw the same noise for one key.
    """
    _check_samples_divisible(cfg, mesh)
    _check_backend(backend)
    chol = sigma_cholesky(cfg.sigma)

    def _plant(qi, dqi, u0):
        d = jnp.asarray(sim.disturbance, dtype=qi.dtype)
        ddq1, ddq2 = arm_ddq(qi[0], qi[1], dqi[0], dqi[1],
                             u0[0] + d[0], u0[1] + d[1], arm)
        dq_new = dqi + sim.dt * jnp.stack([ddq1, ddq2])
        return qi + sim.dt * dq_new, dq_new

    def _per_device(ref_path, q, dq, u_prev, wp_idx, keys):
        def one(qi, dqi, ui, wi, ki):
            shard = lax.axis_index(SAMPLES_AXIS)
            key = jax.random.fold_in(jax.random.wrap_key_data(ki), shard)
            n_shards = lax.axis_size(SAMPLES_AXIS)
            k_local = cfg.num_samples // n_shards
            eps = sample_epsilon(key, k_local, cfg.horizon, chol, ui.dtype)

            observed = jnp.concatenate([qi, dqi])
            u0, _, u_next, wp_new, path_end, _, _ = _solve_local(
                arm, cfg, ref_path, observed, ui, wi, eps, backend=backend)

            q_new, dq_new = _plant(qi, dqi, u0)
            keep = lambda new, old: jnp.where(path_end, old, new)
            return (keep(q_new, qi), keep(dq_new, dqi),
                    keep(u_next, ui), keep(wp_new, wi), path_end, u0)

        return jax.vmap(one)(q, dq, u_prev, wp_idx, keys)

    fn = shard_map(
        _per_device,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                  P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                   P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    return jax.jit(fn)


def scenario_sharding(mesh: Mesh, *batch_axes_only: int) -> NamedSharding:
    """NamedSharding placing the leading batch axis on 'data'."""
    return NamedSharding(mesh, P(DATA_AXIS))
