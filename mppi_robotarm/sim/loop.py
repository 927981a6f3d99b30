"""Closed-loop receding-horizon simulator.

The reference driver is a Python for-loop (run.py:48-71): per step it runs
one MPPI solve, integrates the plant one semi-implicit Euler step at dt=0.003
(run.py:53-55 — the controller model runs at 2·dt, quirk Q2), records state,
and raises ``IndexError`` at the path end (via control.py:76-78).

Two drivers are provided:
  * :func:`simulate` — a ``lax.scan``-compiled simulator: the entire closed
    loop (solve + plant step + recording) is one XLA program, so per-step
    Python dispatch is amortised away (SURVEY.md §6 hard part (e)).  The
    path-end IndexError becomes a ``done`` freeze-flag carried through the
    scan (§5.2: checkify-style error flag instead of a host exception).
  * :func:`simulate_python` — a host-loop driver with reference-exact
    IndexError behaviour, used for parity tests and interactive runs.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import ArmParams, MPPIConfig, SimConfig
from ..models.arm import arm_ddq, fk_full
from ..mppi.solver import MPPIState, init_state, solve
from ..ops.weights import effective_sample_size, weight_entropy


class SimState(NamedTuple):
    """Full closed-loop state — also the checkpointable unit (SURVEY.md §5.4)."""

    step: jnp.ndarray            # () int32
    q: jnp.ndarray               # (2,)
    dq: jnp.ndarray              # (2,)
    mppi: MPPIState
    key: jax.Array
    done: jnp.ndarray            # () bool — path-end freeze flag (Q6)


class SimRecord(NamedTuple):
    """Per-step records mirroring run.py:39-46 (q, u, EE pos, refs)."""

    q: jnp.ndarray               # (steps, 2)
    dq: jnp.ndarray              # (steps, 2)
    u: jnp.ndarray               # (steps, 2)
    ee: jnp.ndarray              # (steps, 2)   end-effector (x2, y2)
    elbow: jnp.ndarray           # (steps, 2)   (x1, y1)
    ref_xy: jnp.ndarray          # (steps, 2)   ref_path[step, 0:2] (run.py:65-66)
    wp_idx: jnp.ndarray          # (steps,)
    cost_min: jnp.ndarray        # (steps,)     solver-health metrics (§5.5)
    cost_mean: jnp.ndarray       # (steps,)
    ess: jnp.ndarray             # (steps,)     effective sample size of w
    weight_entropy: jnp.ndarray  # (steps,)     Shannon entropy of w
    done: jnp.ndarray            # (steps,) bool


def init_sim(cfg: MPPIConfig, sim: SimConfig, key: jax.Array,
             dtype=jnp.float32) -> SimState:
    return SimState(
        step=jnp.asarray(0, jnp.int32),
        q=jnp.asarray(sim.q0, dtype=dtype),
        dq=jnp.asarray(sim.dq0, dtype=dtype),
        mppi=init_state(cfg, dtype=dtype),
        key=key,
        done=jnp.asarray(False),
    )


def plant_step(arm: ArmParams, sim: SimConfig, q, dq, u):
    """Plant integration ``dq += dt·ddq; q += dt·dq_new`` (run.py:53-55),
    with the optional disturbance torque (SURVEY.md §5.3; the reference's
    unused ``isDesturbance`` flag, run.py:16)."""
    d = jnp.asarray(sim.disturbance, dtype=q.dtype)
    ddq1, ddq2 = arm_ddq(q[0], q[1], dq[0], dq[1], u[0] + d[0], u[1] + d[1],
                         arm)
    dq = dq + sim.dt * jnp.stack([ddq1, ddq2])
    q = q + sim.dt * dq
    return q, dq


def sim_step(arm: ArmParams, cfg: MPPIConfig, sim: SimConfig,
             ref_path: jnp.ndarray, state: SimState,
             eps: Optional[jnp.ndarray] = None, backend: str = "xla"):
    """One closed-loop step: solve → plant → record.  Freezes when done."""
    observed = jnp.concatenate([state.q, state.dq])
    if eps is None:
        key, sub = jax.random.split(state.key)
        res = solve(arm, cfg, ref_path, observed, state.mppi, key=sub,
                    backend=backend)
    else:
        key = state.key
        res = solve(arm, cfg, ref_path, observed, state.mppi, eps=eps,
                    backend=backend)

    done = jnp.logical_or(state.done, res.path_end)
    q_new, dq_new = plant_step(arm, sim, state.q, state.dq, res.u0)

    # Freeze all state once the path end is reached (the reference would have
    # raised IndexError and stopped the run, control.py:76-78).
    keep = lambda new, old: jnp.where(done, old, new)
    next_state = SimState(
        step=state.step + jnp.where(done, 0, 1),
        q=keep(q_new, state.q),
        dq=keep(dq_new, state.dq),
        mppi=MPPIState(
            u_prev=keep(res.state.u_prev, state.mppi.u_prev),
            wp_idx=keep(res.state.wp_idx, state.mppi.wp_idx),
        ),
        key=key,
        done=done,
    )
    return next_state, res


@partial(jax.jit,
         static_argnames=("arm", "cfg", "sim", "num_steps", "backend"))
def simulate(
    arm: ArmParams,
    cfg: MPPIConfig,
    sim: SimConfig,
    ref_path: jnp.ndarray,
    state0: SimState,
    num_steps: int,
    backend: str = "xla",
):
    """Scan-compiled closed loop (run.py:48-71 as ONE device program).

    Returns (final SimState, SimRecord of per-step arrays).
    """
    def body(state, step_i):
        next_state, res = sim_step(arm, cfg, sim, ref_path, state,
                                   backend=backend)
        x1, y1, x2, y2 = fk_full(next_state.q[0], next_state.q[1], arm)
        # ref row indexed by the ABSOLUTE step (run.py:65-66 records
        # ref_path[k] with k the global iteration) — state0.step offsets a
        # chunked/checkpoint-resumed run so its records stay step-aligned
        ref_row = lax.dynamic_slice_in_dim(
            ref_path,
            jnp.minimum(state0.step + step_i + 1, ref_path.shape[0] - 1),
            1, 0)[0]
        # after path end the record carries the frozen state with u/cost
        # lanes zeroed
        dn = next_state.done
        zero = lambda v: jnp.where(dn, jnp.zeros_like(v), v)
        rec = SimRecord(
            q=next_state.q, dq=next_state.dq, u=zero(res.u0),
            ee=jnp.stack([x2, y2]), elbow=jnp.stack([x1, y1]),
            ref_xy=ref_row[0:2], wp_idx=next_state.mppi.wp_idx,
            cost_min=zero(jnp.min(res.costs)),
            cost_mean=zero(jnp.mean(res.costs)),
            ess=zero(effective_sample_size(res.weights)),
            weight_entropy=zero(weight_entropy(res.weights)),
            done=dn,
        )
        return next_state, rec

    return lax.scan(body, state0, jnp.arange(num_steps))


def init_sim_batch(cfg: MPPIConfig, sim: SimConfig, keys: jax.Array,
                   q0=None, dq0=None, dtype=jnp.float32) -> SimState:
    """Batched SimState for B parallel tracking scenarios (BASELINE config 4).

    ``keys``: (B,)-batched PRNG keys; ``q0``/``dq0``: optional (B, 2)
    per-scenario initial states (default: the preset initial state).
    """
    b = keys.shape[0]
    tile = lambda v: jnp.broadcast_to(jnp.asarray(v, dtype), (b, 2))
    return SimState(
        step=jnp.zeros((b,), jnp.int32),
        q=tile(sim.q0) if q0 is None else jnp.asarray(q0, dtype),
        dq=tile(sim.dq0) if dq0 is None else jnp.asarray(dq0, dtype),
        mppi=MPPIState(
            u_prev=jnp.broadcast_to(
                jnp.asarray(cfg.warm_start, dtype),
                (b, cfg.horizon, 2)),
            wp_idx=jnp.zeros((b,), jnp.int32),
        ),
        key=keys,
        done=jnp.zeros((b,), bool),
    )


@partial(jax.jit,
         static_argnames=("arm", "cfg", "sim", "num_steps", "backend"))
def simulate_batch(
    arm: ArmParams,
    cfg: MPPIConfig,
    sim: SimConfig,
    ref_path: jnp.ndarray,
    states0: SimState,
    num_steps: int,
    backend: str = "xla",
):
    """B independent closed-loop scenarios on one device.

    Same semantics as :func:`simulate` per scenario: the whole step is
    vmapped, and with backend='pallas' the batch becomes a grid axis of the
    one rollout kernel launch per step.  For several devices, shard the
    batch with parallel.sharded.make_sharded_sim_step instead.
    """
    def _record(next_state, res, step_i, step0):
        x1, y1, x2, y2 = fk_full(next_state.q[0], next_state.q[1], arm)
        # absolute step index (step0 = this scenario's step count at entry)
        # keeps chunked/resumed runs step-aligned with run.py:65-66
        ref_row = lax.dynamic_slice_in_dim(
            ref_path, jnp.minimum(step0 + step_i + 1, ref_path.shape[0] - 1),
            1, 0)[0]
        dn = next_state.done
        zero = lambda v: jnp.where(dn, jnp.zeros_like(v), v)
        return SimRecord(
            q=next_state.q, dq=next_state.dq, u=zero(res.u0),
            ee=jnp.stack([x2, y2]), elbow=jnp.stack([x1, y1]),
            ref_xy=ref_row[0:2], wp_idx=next_state.mppi.wp_idx,
            cost_min=zero(jnp.min(res.costs)),
            cost_mean=zero(jnp.mean(res.costs)),
            ess=zero(effective_sample_size(res.weights)),
            weight_entropy=zero(weight_entropy(res.weights)),
            done=dn,
        )

    def body(states, step_i):
        def one(state, step0):
            next_state, res = sim_step(arm, cfg, sim, ref_path, state,
                                       backend=backend)
            return next_state, _record(next_state, res, step_i, step0)

        return jax.vmap(one, in_axes=(0, 0))(states, states0.step)

    return lax.scan(body, states0, jnp.arange(num_steps))


def simulate_python(
    arm: ArmParams,
    cfg: MPPIConfig,
    sim: SimConfig,
    ref_path: jnp.ndarray,
    state0: SimState,
    num_steps: int,
    eps_per_step=None,
):
    """Host-loop driver with reference-exact error behaviour.

    Raises ``IndexError`` at the path end like control.py:76-78.  When
    ``eps_per_step`` (iterable of (K, T, 2) arrays) is given the solver uses
    the injected noise — the golden-parity seam for closed-loop tests.
    """
    state = state0
    records = []
    for i in range(num_steps):
        eps = None if eps_per_step is None else eps_per_step[i]
        state, res = sim_step(arm, cfg, sim, ref_path, state, eps=eps)
        if bool(state.done):
            raise IndexError("Reached the end of the reference path.")
        records.append((np.asarray(state.q), np.asarray(state.dq),
                        np.asarray(res.u0), int(state.mppi.wp_idx)))
    return state, records
