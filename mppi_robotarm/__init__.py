"""mppi_robotarm — an MPPI trajectory-optimization engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
junofficial/mppi_RobotArm (2-link planar arm, MPPI path tracking): a batched
K×T rollout (XLA scan, or one Pallas kernel on the GPU), scan-compiled
closed-loop simulation, and sample/scenario sharding over device meshes with
psum/pmin collectives.
See SURVEY.md at the repo root for the structural map of the reference and
the exact quirks (Q1-Q13) replicated for numeric parity.
"""

from .config import (
    ArmParams,
    MPPIConfig,
    SimConfig,
    benchmark_preset,
    circle_tracking_preset,
    high_accuracy_preset,
    config_from_json,
    config_to_json,
)
from .mppi.solver import (
    MPPIState,
    SolveResult,
    VizResult,
    init_state,
    solve,
    viz_rollouts,
)
from .sim.loop import (
    SimRecord,
    SimState,
    init_sim,
    init_sim_batch,
    simulate,
    simulate_batch,
    simulate_python,
)
from .sim.pathgen import generate_circle_path, save_path_file
from .sim.paths import load_ref_path, synth_circle_path

__version__ = "0.1.0"

__all__ = [
    "ArmParams", "MPPIConfig", "SimConfig",
    "benchmark_preset", "circle_tracking_preset",
    "high_accuracy_preset",
    "config_from_json", "config_to_json",
    "MPPIState", "SolveResult", "VizResult", "init_state", "solve",
    "viz_rollouts",
    "SimRecord", "SimState", "init_sim", "init_sim_batch", "simulate",
    "simulate_batch", "simulate_python",
    "generate_circle_path",
    "save_path_file",
    "load_ref_path", "synth_circle_path",
]
