"""Example: the reference's run.py driver, unchanged, on the compat layer.

    python examples/reference_drop_in.py [steps]

This is what a user of junofficial/mppi_RobotArm writes after switching —
the same host-side closed loop as run.py:48-71 (plant Euler at dt=0.003,
record arrays, Figure-1/2 at the end), with ONLY the imports changed to
``mppi_robotarm.compat``.  The MPPI solve inside
``calc_control_input`` runs as one compiled XLA program instead of the
reference's Python triple loop.

For production use prefer the framework-native drivers (``m.simulate`` /
``m.simulate_fused``) — keeping the loop on the host pays per-step dispatch
latency that the scan/fused drivers eliminate.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

# the reference's imports, redirected — this is the only change
from mppi_robotarm.compat import (
    MPPIControllerForPathTracking,
    Arm_Dynamic,
    Forward_Kinemetic,
    SYS_PARAMS,
)


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 100

    params = SYS_PARAMS()
    assert params["l1"] == params["l2"] == 1

    # run.py:10-19
    delta_t = 0.003
    q = np.array([1.1522, -1.2661])
    dq = np.zeros(2)
    ref_file = "/root/reference/xydq_circle.txt"
    if os.path.exists(ref_file):
        ref_path = np.loadtxt(ref_file)[:, 0:4]
    else:
        from mppi_robotarm.sim.paths import synth_circle_path
        ref_path = synth_circle_path(2000)

    # run.py:25-37 — the exact reference configuration
    np.random.seed(0)
    mppi = MPPIControllerForPathTracking(
        delta_t=delta_t * 2.0,
        ref_path=ref_path,
        horizon_step_T=30,
        number_of_samples_K=100,
        param_exploration=0.0,
        param_lambda=100.0,
        param_alpha=0.98,
        sigma=np.array([[20.0, 0.0], [0.0, 20.0]]),
        stage_cost_weight=np.array([0.5, 0.5, 5.0, 5.0]),
        terminal_cost_weight=np.array([5.0, 5.0, 50.0, 50.0]),
        visualize_optimal_traj=True,
        visualze_sampled_trajs=False,
    )

    x_rec, y_rec, err = [], [], []
    for k in range(steps):
        state = np.concatenate([q, dq])
        try:
            u, u_seq, optimal_traj, sampled = mppi.calc_control_input(
                observed_x=state)
        except IndexError:
            print(f"path end reached at step {k}")
            break
        # plant step (run.py:53-55): semi-implicit Euler at dt
        dq = dq + delta_t * Arm_Dynamic(q, dq, u)
        q = q + delta_t * dq
        _, _, x2, y2 = Forward_Kinemetic(q)
        x_rec.append(x2)
        y_rec.append(y2)
        err.append(np.hypot(x2 - ref_path[k + 1, 0],
                            y2 - ref_path[k + 1, 1]))

    err = np.asarray(err)
    print(f"{len(err)} steps; mean EE tracking error "
          f"{err.mean() * 1e3:.2f} mm, max {err.max() * 1e3:.2f} mm, "
          f"final wp idx {mppi.prev_waypoints_idx}")


if __name__ == "__main__":
    main()
