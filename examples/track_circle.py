"""Example: closed-loop circle tracking — the reference run.py, compiled.

    python examples/track_circle.py [steps] [backend]

Runs the scan-compiled closed loop at the reference configuration (K=100,
T=30 MPPI tracking xydq_circle-style path), prints tracking stats, and saves
the reference-parity figures next to this script.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

import mppi_robotarm as m


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    backend = sys.argv[2] if len(sys.argv) > 2 else "xla"

    arm, cfg, sim = m.circle_tracking_preset()
    ref_file = "/root/reference/xydq_circle.txt"
    ref = (m.load_ref_path(ref_file) if os.path.exists(ref_file)
           else m.synth_circle_path(2000))

    state = m.init_sim(cfg, sim, jax.random.PRNGKey(0))
    final, rec = m.simulate(arm, cfg, sim, jnp.asarray(ref), state, steps,
                            backend=backend)
    jax.block_until_ready(rec.q)

    from mppi_robotarm.utils.metrics import tracking_errors
    errs = tracking_errors(np.asarray(rec.ee), ref[1:steps + 1, 0:2])
    print({k: round(v * 1e3, 3) for k, v in errs.items()}, "(mm)")

    from mppi_robotarm.utils.plotting import plot_results
    fig1, fig2 = plot_results(rec, ref)
    out = os.path.dirname(os.path.abspath(__file__))
    fig1.savefig(os.path.join(out, "tracking.png"), dpi=130)
    fig2.savefig(os.path.join(out, "controls.png"), dpi=130)
    print("figures saved to", out)


if __name__ == "__main__":
    main()
