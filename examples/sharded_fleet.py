"""Example: a scenario fleet sharded over a ('data', 'samples') device mesh.

Demonstrates the multi-device API (MULTICHIP.md) end-to-end on every
device JAX finds: scenarios over 'data', each scenario's K samples over
'samples', with the three pmin/psum collectives per solve.

    python examples/sharded_fleet.py [batch] [steps] [xla|pallas]

On a host without GPUs, give JAX virtual CPU devices and the XLA backend:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/sharded_fleet.py 16 50 xla
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import dataclasses
import time

import numpy as np
import jax
import jax.numpy as jnp

import mppi_robotarm as m
from mppi_robotarm.parallel.mesh import initialize_multihost, make_mesh
from mppi_robotarm.parallel.sharded import make_sharded_sim_step


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    backend = sys.argv[3] if len(sys.argv) > 3 else "pallas"

    initialize_multihost()                    # no-op on a single host
    n = len(jax.devices())
    samples_ax = 2 if n % 2 == 0 else 1
    mesh = make_mesh(samples=samples_ax)
    print(f"devices: {n} ({jax.devices()[0].platform}); "
          f"mesh {n // samples_ax}x{samples_ax} (data x samples)")

    arm, cfg, sim = m.circle_tracking_preset()
    cfg = dataclasses.replace(cfg, num_samples=64 * samples_ax, horizon=12)
    step_fn = make_sharded_sim_step(arm, cfg, sim, mesh, backend=backend)

    ref = jnp.asarray(m.synth_circle_path(2000), jnp.float32)
    q = jnp.tile(jnp.asarray([sim.q0], jnp.float32), (batch, 1))
    dq = jnp.zeros((batch, 2), jnp.float32)
    u_prev = jnp.tile(jnp.asarray(cfg.warm_start, jnp.float32),
                      (batch, cfg.horizon, 1))
    wp_idx = jnp.zeros((batch,), jnp.int32)

    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    for i in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.key_data(
            jax.vmap(lambda s: jax.random.fold_in(sub, s))(
                jnp.arange(batch))).astype(jnp.uint32)
        q, dq, u_prev, wp_idx, done, u0 = step_fn(ref, q, dq, u_prev,
                                                  wp_idx, keys)
    jax.block_until_ready(q)
    wall = time.perf_counter() - t0

    ee_x = np.cos(np.asarray(q[:, 0])) + np.cos(np.asarray(q).sum(1))
    ee_y = np.sin(np.asarray(q[:, 0])) + np.sin(np.asarray(q).sum(1))
    ref_np = np.asarray(ref)
    d = np.linalg.norm(
        np.stack([ee_x, ee_y], 1)[:, None, :] - ref_np[None, :, 0:2],
        axis=2).min(axis=1)
    print(f"{batch} scenarios x {steps} steps in {wall:.2f}s "
          f"({batch * steps / wall:.0f} scenario-solves/s incl. compile "
          f"and dispatch)")
    print(f"on-path EE error after {steps} steps: median "
          f"{np.median(d) * 1e3:.1f} mm, p95 {np.percentile(d, 95) * 1e3:.1f} mm")
    print(f"wp_idx range: {int(np.min(np.asarray(wp_idx)))}.."
          f"{int(np.max(np.asarray(wp_idx)))}; any done: "
          f"{bool(np.any(np.asarray(done)))}")


if __name__ == "__main__":
    main()
