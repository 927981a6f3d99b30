"""Pallas kernel for the GPU (Triton route): K noisy rollouts and their costs
in one launch.

:func:`ops.rollout.rollout_costs` is a ``lax.scan`` over the horizon.  On a
GPU every scan step is at least one kernel launch, and the (K,) state makes a
round trip through device memory between launches.  Here one program owns
``block_k`` samples, one per lane, and carries ``q1, q2, dq1, dq2`` and the
running cost ``S`` in registers through a ``fori_loop`` over the horizon:
one launch per solve.  Programs are independent, so nothing is reduced
across them: the kernel returns S only, and the softmax weights, Σwε, the
median filter and the control update stay in XLA.

Semantics are those of ``rollout_costs`` (SURVEY.md §3.2): the exploration
split over the GLOBAL sample index (Q9, so a K-sharded caller passes
``k_offset``), the stage cost on the post-step state plus γ·uᵀΣ⁻¹v, the
frozen-window nearest-waypoint lookup with first-win ties (Q5), the terminal
cost, and the cost and distance scales (Q7).  The arm equations are
``models.arm.arm_step`` / ``fk_ee`` applied to the lane vectors.

Noise comes from outside (``ops.noise.sample_epsilon``), so the ``pallas``
and ``xla`` backends see identical noise for one key.  The wrapper lays it
out K-contiguous, (T, 2, K_pad), so each step's loads are coalesced; that
transpose reads and writes 8·K·T bytes once per solve.

The kernel is compiled for the GPU.  Lowered for the CPU (the test suite's
host) it runs in Pallas interpret mode instead, the one way it runs there;
``lax.platform_dependent`` makes that choice when the caller is lowered, so
no GPU lowering ever carries the interpreted form.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import ArmParams, MPPIConfig
from ..models.arm import arm_step, fk_ee

_LANES_MIN = 32          # one warp
_LANES_MAX = 128         # four warps
_NUM_SMS = 132           # H100 SXM


def block_k(num_samples: int) -> int:
    """Samples per program: a power of two in [32, 128].

    Small K spreads over as many SMs as it can, one warp per program; past
    K = 132·32 every SM has work and programs grow, up to four warps.
    """
    per_sm = -(-num_samples // _NUM_SMS)
    return min(_LANES_MAX, max(_LANES_MIN, pl.next_power_of_2(per_sm)))


def _tracking_cost(q1, q2, dq1, dq2, win_ref, nvalid, weights,
                   cfg: MPPIConfig):
    """Stage/terminal cost against the nearest valid row of the frozen window.

    A first-win scan (strict ``<``) over the ``search_idx_len`` rows, the
    same selection as ``ops.waypoint.nearest_in_window``'s masked argmin.
    """
    x, y = fk_ee(q1, q2, cfg.l1, cfg.l2)
    best = jnp.full_like(x, jnp.inf)
    rx = ry = rdq1 = rdq2 = jnp.zeros_like(x)
    for j in range(cfg.search_idx_len):
        wx, wy = win_ref[j, 0], win_ref[j, 1]
        dx = x - wx
        dy = y - wy
        d = (dx * dx + dy * dy) * cfg.dist_scale
        take = (d < best) & (j < nvalid)
        best = jnp.where(take, d, best)
        rx = jnp.where(take, wx, rx)
        ry = jnp.where(take, wy, ry)
        rdq1 = jnp.where(take, win_ref[j, 2], rdq1)
        rdq2 = jnp.where(take, win_ref[j, 3], rdq2)
    ex, ey, e1, e2 = x - rx, y - ry, dq1 - rdq1, dq2 - rdq2
    c = (weights[0] * (ex * ex) + weights[1] * (ey * ey)
         + weights[2] * (e1 * e1) + weights[3] * (e2 * e2))
    return c * cfg.cost_scale


def _kernel(x0_ref, uu_ref, eps_ref, win_ref, ints_ref, s_ref, *,
            arm: ArmParams, cfg: MPPIConfig, lanes: int):
    k0 = pl.program_id(0) * lanes
    cols = pl.ds(k0, lanes)
    nvalid = ints_ref[0]
    k_global = ints_ref[1] + k0 + jnp.arange(lanes)
    exploit = (k_global.astype(jnp.float32)
               < (1.0 - cfg.exploration) * cfg.num_samples)
    gamma = cfg.gamma

    def step(t, carry):
        q1, q2, dq1, dq2, s = carry
        u1, u2 = uu_ref[t, 0], uu_ref[t, 1]
        su1, su2 = uu_ref[t, 2], uu_ref[t, 3]
        e1 = eps_ref[t, 0, cols]
        e2 = eps_ref[t, 1, cols]
        v1 = jnp.where(exploit, u1 + e1, e1)
        v2 = jnp.where(exploit, u2 + e2, e2)
        if cfg.u_clamp is not None:            # reference `_g` clamp (Q11)
            v1 = jnp.clip(v1, -cfg.u_clamp, cfg.u_clamp)
            v2 = jnp.clip(v2, -cfg.u_clamp, cfg.u_clamp)
        q1, q2, dq1, dq2 = arm_step(q1, q2, dq1, dq2, v1, v2, cfg.delta_t,
                                    arm)
        c = _tracking_cost(q1, q2, dq1, dq2, win_ref, nvalid,
                           cfg.stage_cost_weight, cfg)
        return q1, q2, dq1, dq2, s + c + gamma * (v1 * su1 + v2 * su2)

    def lane(i):
        return jnp.full((lanes,), x0_ref[i], jnp.float32)

    init = (lane(0), lane(1), lane(2), lane(3),
            jnp.zeros((lanes,), jnp.float32))
    q1, q2, dq1, dq2, s = lax.fori_loop(0, cfg.horizon, step, init)
    s_ref[cols] = s + _tracking_cost(q1, q2, dq1, dq2, win_ref, nvalid,
                                     cfg.terminal_cost_weight, cfg)


def rollout_costs_pallas(
    arm: ArmParams,
    cfg: MPPIConfig,
    x0: jnp.ndarray,          # (4,) observed state [q1, q2, dq1, dq2]
    u: jnp.ndarray,           # (T, 2) nominal control sequence
    eps: jnp.ndarray,         # (K_local, T, 2) exploration noise
    window: jnp.ndarray,      # (W, 4) frozen waypoint window
    valid: jnp.ndarray,       # (W,) window validity mask
    sigma_inv: jnp.ndarray,   # (2, 2)
    k_offset=0,               # global index of this shard's first sample
) -> jnp.ndarray:
    """Per-sample total costs S (K_local,), float32 — ``rollout_costs``'s S.

    Batches are ``jax.vmap`` of this function; the batch becomes a grid
    axis of the one launch.
    """
    f32 = jnp.float32
    k_loc = eps.shape[0]
    lanes = block_k(k_loc)
    k_pad = pl.cdiv(k_loc, lanes) * lanes
    eps_t = jnp.pad(jnp.transpose(eps.astype(f32), (1, 2, 0)),
                    ((0, 0), (0, 0), (0, k_pad - k_loc)))
    u = u.astype(f32)
    sinv = jnp.asarray(sigma_inv, f32)
    # Σ⁻¹u as multiply-and-sum: exact float32, never a TF32 contraction
    su = (sinv[None, :, :] * u[:, None, :]).sum(axis=-1)
    ints = jnp.stack([jnp.sum(valid.astype(jnp.int32)),
                      jnp.asarray(k_offset, jnp.int32)])
    kernel = functools.partial(_kernel, arm=arm, cfg=cfg, lanes=lanes)

    def call(interpret, *args):
        return pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct((k_pad,), f32),
            grid=(k_pad // lanes,),
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=lanes // 32,
                                                 num_stages=1),
            interpret=interpret,
            name="mppi_rollout_costs",
        )(*args)

    s = lax.platform_dependent(
        x0.astype(f32), jnp.concatenate([u, su], axis=1), eps_t,
        window.astype(f32), ints,
        cpu=functools.partial(call, True),
        default=functools.partial(call, False))
    return s[:k_loc]
