"""Example: thousands of parallel tracking scenarios on one device
(BASELINE config 4), the batch a grid axis of the rollout kernel.

    python examples/multi_scenario.py [B] [K] [steps] [xla|pallas]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

import mppi_robotarm as m


def main():
    b = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 30
    backend = sys.argv[4] if len(sys.argv) > 4 else "pallas"

    arm, cfg, sim = m.circle_tracking_preset()
    cfg = dataclasses.replace(cfg, num_samples=k)
    ref = jnp.asarray(m.synth_circle_path(2000))

    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b))
    q0 = (jnp.asarray([sim.q0], jnp.float32)
          + 0.02 * jax.random.normal(jax.random.PRNGKey(1), (b, 2)))
    states = m.init_sim_batch(cfg, sim, keys, q0=q0)

    final, rec = m.simulate_batch(arm, cfg, sim, ref, states, steps,
                                  backend=backend)
    jax.block_until_ready(rec.q)

    ee = np.asarray(rec.ee[-1])                     # (B, 2) at final step
    err = np.linalg.norm(ee - np.asarray(ref)[steps, 0:2], axis=-1)
    print(f"B={b} K={k}: median EE error at step {steps}: "
          f"{np.median(err)*1e3:.2f} mm; "
          f"p95 {np.percentile(err, 95)*1e3:.2f} mm; "
          f"all finite: {np.all(np.isfinite(ee))}")


if __name__ == "__main__":
    main()
